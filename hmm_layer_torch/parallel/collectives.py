"""The mesh and its collectives over ``torch.distributed``.

The JAX package runs its sharded functions as ``shard_map`` bodies over a
device mesh; here each rank is one process (SPMD) that runs the body's
code on its own block, and the ``lax`` collectives become calls on the
process group of a mesh axis:

=========================  ====================================
``lax.psum/pmax/pmin``     :func:`psum`, :func:`pmax`, :func:`pmin`
                           (``dist.all_reduce``)
``lax.all_gather``         :func:`all_gather`
``lax.ppermute`` shifts    :func:`shift_from_next`, :func:`shift_from_prev`
                           (one all-gather of the tiny edge values: gloo's
                           send of a CUDA tensor aborts the process)
``lax.axis_index``         :meth:`Mesh.index`
=========================  ====================================

The autograd-aware forms keep the JAX gradients of the global program
(in their global mode the sharded functions take the global tensors on
every rank and return the global result on every rank, so the cotangent
of a result is the same on every rank; in their rank-local mode a rank's
blocks come in and go out as they are, and its cotangents are its own):

* :func:`replicated` — identity; its backward sums the ranks' partial
  gradients over the given axes (a tensor every rank holds whole, read
  by each rank's own block of work);
* :func:`scatter` — this rank's block along a dim; backward all-gathers;
* :func:`gather` — all-gathers the blocks; backward keeps this rank's
  block of the (replicated) cotangent (both also take ragged row blocks,
  :func:`row_sizes`, for the data route; every other split must divide);
* :func:`psum_ad` and :func:`all_gather_ad` — an all-reduce and an
  all-gather inside a rank's recursion, whose backwards sum the ranks'
  cotangents (and keep this rank's block);
* :func:`replicated_out` and :func:`mean_out` — a result every rank
  computes whole (its cotangent goes to the first rank of the axes only),
  and the row-weighted mean of the ranks' values;
* :func:`replicated_many` — :func:`replicated` of several tensors with one
  all-reduce in the backward (a module's parameters, read by each rank's
  own block of work), and :func:`sum_out` — the sum of the ranks' partial
  values, each rank's cotangent its own part's.

Inside a sharded function each rank's cotangents are its own part of the
whole (the ``gather`` backward gives each rank its block), so the
gradients of every rank's inputs sum, through :func:`replicated`, to the
gradient of the global program.

The all-gather gathers into one flat buffer (``all_gather_single`` /
``all_gather_into_tensor``) under NCCL and gloo alike; gloo takes CPU and
CUDA tensors that way (several ranks sharing one GPU run gloo: NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "psum",
    "pmax",
    "pmin",
    "all_gather",
    "row_sizes",
    "state_block",
    "LocalRanges",
    "local_ranges",
    "block",
    "gather_rows",
    "shift_from_next",
    "shift_from_prev",
    "replicated",
    "scatter",
    "gather",
    "psum_ad",
    "all_gather_ad",
    "replicated_out",
    "mean_out",
    "replicated_many",
    "sum_out",
]


class Mesh:
    """Named mesh axes over the ranks of the initialised process group.

    Ranks ``0 .. n-1`` are laid out row-major over the axes in the order
    given (the JAX ``make_mesh`` reshapes its device list the same way);
    each axis has one process group per line of ranks along it.
    ``shape`` maps axis names to sizes, as ``jax.sharding.Mesh.shape``.
    Without an initialised process group the mesh holds one rank and
    every collective is the identity.
    """

    def __init__(self, axis_sizes: dict[str, int]):
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if world < self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, have {world}")
        self.rank = dist.get_rank() if self.distributed else 0
        sizes = tuple(self.shape.values())
        self.coords = (
            dict(zip(self.axis_names, _unravel(self.rank, sizes))) if self.rank < self.size else None
        )
        self._groups = {}
        if self.distributed:
            # Every rank creates every group, in the same order (new_group
            # is collective over the whole world).
            for a, name in enumerate(self.axis_names):
                others = [range(n) for i, n in enumerate(sizes) if i != a]
                for rest in itertools.product(*others):
                    ranks = []
                    for k in range(sizes[a]):
                        coord = list(rest)
                        coord.insert(a, k)
                        ranks.append(_ravel(coord, sizes))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[name] = group

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups.get(axis)

    def active(self, axis: str | None) -> bool:
        """Whether ``axis`` needs collectives: named, and a process group
        exists (at world size 1 under a process group too, so the backend
        runs)."""
        return axis is not None and self.distributed


def _unravel(rank, sizes):
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(coord, sizes):
    r = 0
    for c, n in zip(coord, sizes):
        r = r * n + c
    return r


def make_mesh(axis_sizes: dict[str, int]) -> Mesh:
    """A mesh from ``{"data": 2, "state": 2, ...}`` over the ranks of the
    initialised process group (:func:`~hmm_layer_torch.parallel.init_distributed`);
    raises ``ValueError`` when the world has fewer ranks than the mesh."""
    return Mesh(axis_sizes)


def _axes(axes):
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(a for a in axes if a is not None)


def _all_reduce(x, mesh, axes, op):
    x = x.contiguous().clone()
    for axis in _axes(axes):
        if mesh.active(axis):
            dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x


def psum(x, mesh: Mesh, axes):
    """Sum of ``x`` over the ranks of ``axes`` (one name or several)."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x, mesh: Mesh, axes):
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


def pmin(x, mesh: Mesh, axes):
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MIN)


def _gather_into():
    """``dist.all_gather_single`` where the installed torch has it (2.13
    deprecates the older name), else ``dist.all_gather_into_tensor``."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x, mesh: Mesh, axis: str | None, dim: int | None = None):
    """The ``axis`` ranks' ``x``: stacked on a new leading dim
    (``dim=None``), or concatenated along ``dim`` (``tiled=True`` in
    ``lax.all_gather``).

    The ranks' blocks land in ONE output buffer (gloo and NCCL both take
    the flat, concatenated form; gloo refuses a stacked ``(n, ...)`` one):
    the stacked result is a view of it, and a concatenation along ``dim >
    0`` costs one more copy."""
    if not mesh.active(axis):
        return x[None] if dim is None else x
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    x = x.contiguous()
    flat = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _gather_into()(flat, x.reshape(-1), group=group)
    out = flat.view(n, *x.shape)
    if dim is None:
        return out
    dim = dim % x.dim()
    shape = (*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
    return out.view(shape) if dim == 0 else out.movedim(0, dim).reshape(shape)


def shift_from_next(x, mesh: Mesh, axis: str):
    """Each rank receives ``x`` of the next rank along ``axis``; the last
    one receives zeros (``lax.ppermute`` with pairs ``(d, d - 1)``)."""
    xs = all_gather(x, mesh, axis)
    idx, n = mesh.index(axis), mesh.shape[axis]
    return xs[idx + 1] if idx < n - 1 else torch.zeros_like(x)


def shift_from_prev(x, mesh: Mesh, axis: str):
    """Each rank receives ``x`` of the previous rank along ``axis``; rank 0
    receives zeros."""
    xs = all_gather(x, mesh, axis)
    idx = mesh.index(axis)
    return xs[idx - 1] if idx > 0 else torch.zeros_like(x)


def row_sizes(size: int, n: int) -> list[int]:
    """Block sizes of ``size`` rows over ``n`` ranks: the first
    ``size % n`` blocks hold one row more (``torch.tensor_split``'s rule)."""
    if size < n:
        raise ValueError(f"{size} rows cannot be split over {n} ranks (fewer rows than ranks)")
    return [size // n + (k < size % n) for k in range(n)]


def state_block(q: int, n: int, k: int) -> tuple[int, int]:
    """Shard ``k``'s ``[start, stop)`` of ``q`` states over ``n`` shards in
    blocks of ``ceil(q / n)`` (``q`` padded to a multiple of ``n``, the
    pad states dropped: the last blocks stop at ``q``)."""
    width = -(-q // n)
    return min(q, k * width), min(q, (k + 1) * width)


class LocalRanges(NamedTuple):
    """A rank's ``[start, stop)`` ranges of the data rows, the positions and
    the states of a global ``(m, b, L, q)`` tensor (:func:`local_ranges`)."""

    rows: tuple[int, int]
    positions: tuple[int, int]
    states: tuple[int, int]

    @property
    def index(self):
        """``x[r.index]`` is the rank's block of a global ``(m, b, L, q)``
        tensor ``x``."""
        return (slice(None), slice(*self.rows), slice(*self.positions), slice(*self.states))


def local_ranges(
    mesh: Mesh,
    route: str,
    shape,
    state_axis: str = "state",
    seq_axis: str = "seq",
    data_axis: str | None = None,
) -> LocalRanges:
    """This rank's block of a global ``(m, b, L, q)`` tensor (``E``, log
    gamma) on a sharded ``route``, as the ``local=True`` mode of the
    sharded functions takes and returns it:

    * ``"edge"`` (``edge_sharded_*``): rows over ``data_axis``, states in
      blocks of ``q_local = ceil(q / n)``; the last blocks stop at ``q``
      (the pad states up to ``q_pad`` are the function's own);
    * ``"state"`` (``state_sharded_*``): rows over ``data_axis``, states in
      blocks of ``q / n`` (``q`` must divide, as the function requires);
    * ``"seq"`` (``seq_sharded_*``): rows over ``data_axis``, positions
      over ``seq_axis``, every state.

    Rows and positions split by :func:`row_sizes` (blocks of equal size
    where the count divides, which the functions' global mode requires).
    A caller builds only its block from these ranges; ``r.index`` slices
    it out of a global tensor."""
    m, b, L, q = shape

    def span(sizes, k):
        start = sum(sizes[:k])
        return start, start + sizes[k]

    rows = span(row_sizes(b, mesh.shape[data_axis]), mesh.index(data_axis)) if data_axis else (0, b)
    positions, states = (0, L), (0, q)
    if route == "seq":
        positions = span(row_sizes(L, mesh.shape[seq_axis]), mesh.index(seq_axis))
    elif route in ("edge", "state"):
        n = mesh.shape[state_axis]
        if route == "state" and q % n:
            raise ValueError(f"q={q} not divisible by state axis size {n}")
        states = state_block(q, n, mesh.index(state_axis))
    else:
        raise ValueError(f"unknown route {route!r} (edge, state or seq)")
    return LocalRanges(rows, positions, states)


def block(x, mesh: Mesh, axis: str | None, dim: int, ragged: bool = False):
    """This rank's block of ``x`` along ``dim``; the whole of ``x`` for
    ``axis=None``. ``dim``'s size must divide by the axis size (a
    ``ValueError`` otherwise, as ``shard_map`` raises), unless ``ragged``:
    then the blocks differ by at most one row (:func:`row_sizes`)."""
    if axis is None:
        return x
    n, size = mesh.shape[axis], x.shape[dim]
    if not ragged and size % n:
        raise ValueError(f"dim {dim} of size {size} not divisible by {axis!r} axis size {n}")
    sizes = row_sizes(size, n)
    idx = mesh.index(axis)
    return x.narrow(dim, sum(sizes[:idx]), sizes[idx])


def gather_rows(x, mesh: Mesh, axis: str | None, dim: int, total: int):
    """The ranks' ragged blocks of ``x`` (:func:`row_sizes` of ``total``)
    concatenated along ``dim``: each block is padded to the largest one
    for the all-gather and cut back after it."""
    if not mesh.active(axis):
        return x
    sizes = row_sizes(total, mesh.shape[axis])
    dim = dim % x.dim()
    if len(set(sizes)) == 1:
        return all_gather(x, mesh, axis, dim)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, sizes[0] - x.shape[dim]]
    parts = all_gather(torch.nn.functional.pad(x, pad), mesh, axis).unbind(0)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)], dim=dim)


# ---------------------------------------------------------------------------
# Autograd-aware forms
# ---------------------------------------------------------------------------


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return psum(ct, ctx.mesh, ctx.axes), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, ragged):
        ctx.mesh, ctx.axis, ctx.dim, ctx.total = mesh, axis, dim, x.shape[dim]
        return block(x, mesh, axis, dim, ragged).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return gather_rows(ct, ctx.mesh, ctx.axis, ctx.dim, ctx.total), None, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, total):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather_rows(x, mesh, axis, dim, total)

    @staticmethod
    def backward(ctx, ct):
        return block(ct, ctx.mesh, ctx.axis, ctx.dim, ragged=True).contiguous(), None, None, None, None


class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, ct):
        return psum(ct, ctx.mesh, ctx.axes), None, None


def _live(axes, mesh):
    return any(mesh.active(a) for a in _axes(axes))


def replicated(x, mesh: Mesh, axes):
    """``x`` as it is; its gradient is summed over the ranks of ``axes``."""
    if not (_live(axes, mesh) and torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Replicated.apply(x, mesh, axes)


def scatter(x, mesh: Mesh, axis: str | None, dim: int, ragged: bool = False):
    """This rank's block of ``x`` along ``dim`` (:func:`block`); its
    gradient is gathered."""
    if axis is None:
        return x
    if not (mesh.active(axis) and torch.is_grad_enabled() and x.requires_grad):
        return block(x, mesh, axis, dim, ragged)
    return _Scatter.apply(x, mesh, axis, dim, ragged)


def gather(x, mesh: Mesh, axis: str | None, dim: int, total: int | None = None):
    """The ranks' blocks of ``x`` concatenated along ``dim`` (ragged blocks
    of ``total`` rows where it is given, :func:`gather_rows`); the gradient
    is this rank's block of the result's (replicated) cotangent."""
    if axis is None:
        return x
    if total is None:
        total = x.shape[dim] * mesh.shape[axis]
    if not (mesh.active(axis) and torch.is_grad_enabled() and x.requires_grad):
        return gather_rows(x, mesh, axis, dim, total)
    return _Gather.apply(x, mesh, axis, dim, total)


def psum_ad(x, mesh: Mesh, axes):
    """:func:`psum` whose backward sums the cotangents over the same ranks."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return psum(x, mesh, axes)
    return _PsumAD.apply(x, mesh, axes)


class _AllGatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, ct):
        total = psum(ct, ctx.mesh, ctx.axis)
        return block(total, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.first = all(mesh.index(a) == 0 for a in _axes(axes))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (ct if ctx.first else torch.zeros_like(ct)), None, None


class _MeanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, share):
        ctx.share = share
        return _weighted_sum(x, mesh, axis, share)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.share, None, None, None


def _weighted_sum(x, mesh, axis, share):
    n = mesh.shape[axis]
    if share == 1 / n:
        return psum(x, mesh, axis) / n
    return psum(x * share, mesh, axis)


def all_gather_ad(x, mesh: Mesh, axis: str, dim: int):
    """:func:`all_gather` along ``dim`` whose backward sums the cotangents
    over the ranks and keeps this rank's block."""
    if not (mesh.active(axis) and torch.is_grad_enabled() and x.requires_grad):
        return all_gather(x, mesh, axis, dim)
    return _AllGatherAD.apply(x, mesh, axis, dim)


def replicated_out(x, mesh: Mesh, axes):
    """A result that every rank of ``axes`` computes whole: as it is, its
    cotangent passed on by the first rank of the axes only."""
    if not (_live(axes, mesh) and torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReplicatedOut.apply(x, mesh, axes)


def mean_out(x, mesh: Mesh, axis: str | None, share: float | None = None):
    """The mean over the ranks of ``axis`` of ``x``, each rank weighted by
    its ``share`` (its fraction of the rows; ``1/n`` by default), and each
    rank's part of the cotangent ``share`` of it."""
    if not mesh.active(axis):
        return x
    if share is None:
        share = 1 / mesh.shape[axis]
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _weighted_sum(x, mesh, axis, share)
    return _MeanOut.apply(x, mesh, axis, share)


class _ReplicatedMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        flat = psum(torch.cat([ct.reshape(-1) for ct in cts]), ctx.mesh, ctx.axes)
        return (None, None, *(g.view_as(ct) for g, ct in zip(flat.split([ct.numel() for ct in cts]), cts)))


def replicated_many(xs, mesh: Mesh, axes):
    """:func:`replicated` of each tensor of ``xs`` (one dtype), the
    gradients summed over the ranks of ``axes`` in ONE all-reduce of their
    concatenation: every rank makes the same single collective, whichever
    of them its block of work reads."""
    xs = tuple(xs)
    if not (xs and _live(axes, mesh) and torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return xs
    return _ReplicatedMany.apply(mesh, axes, *xs)


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def sum_out(x, mesh: Mesh, axes):
    """The sum over the ranks of ``axes`` of each rank's partial value
    ``x`` (a loss summed over blocks); each rank's part of the cotangent is
    the whole cotangent, as the sum's gradient is with respect to each
    term."""
    if not _live(axes, mesh):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return psum(x, mesh, axes)
    return _SumOut.apply(x, mesh, axes)
