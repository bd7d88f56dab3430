"""Plan7 profile-HMM transitions with silent-state elimination (port of
``hmm_layer_tpu/models/profile_transitions.py``).

* Parameters are **named kernel parts**: one logit vector per edge type of
  the *explicit* model (18 types), the left and right flank sharing their
  loop and exit kernels, each part optionally frozen.
* Probabilities come from a per-row softmax over the explicit sparse
  pattern (``3L+5`` states including BEGIN, END and the DELETEs).
* **Silent-state elimination**: the delete chains are marginalised into
  an implicit dense model over ``2L+3`` states with the cumulative-sum
  trick ``match_skip(i, j) = MD_i + (DD-cumsum_j - DD-cumsum_i) + DM_j``
  (the upper triangle including the diagonal).
* The initial distribution comes from a sigmoid flank-init plus the
  implicit entry probabilities.
* Several models are padded to the largest state count with ``LOG_ZERO``
  (−1e3), in ``A`` and in the initial distribution.

State order (implicit): ``LEFT_FLANK, MATCH x L, INSERT x L-1,
UNANNOTATED_SEGMENT, RIGHT_FLANK, TERMINAL``. Explicit adds ``BEGIN, END,
DELETE x L`` at the end.

The module owns its parameters under the JAX params' tree paths:
``kernels.{i}.{part}`` (one ``nn.ParameterDict`` per model, a shared part
stored once under its canonical name) and ``flank_init_kernel.{i}``, so
:func:`~hmm_layer_torch.convert.load_jax_params` and the checkpoints carry
them across strictly. Frozen parts have ``requires_grad=False``. The dense
matrices are built out of place (``index_put``), so autograd reaches every
logit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.semiring import LOG_ZERO
from . import initializers as inits
from .priors import ProfileHMMTransitionPrior

__all__ = [
    "ProfileTransitions",
    "get_num_states",
    "get_num_states_implicit",
    "explicit_transition_kernel_parts",
    "implicit_transition_parts",
]


def get_num_states(lengths):
    """Implicit profile-HMM state count per model."""
    return [2 * l + 3 for l in lengths]


def get_num_states_implicit(lengths):
    """Explicit state count per model, silent states included."""
    return [3 * l + 5 for l in lengths]


def explicit_transition_kernel_parts(length):
    return [
        ("begin_to_match", length),
        ("match_to_end", length),
        ("match_to_match", length - 1),
        ("match_to_insert", length - 1),
        ("insert_to_match", length - 1),
        ("insert_to_insert", length - 1),
        ("match_to_delete", length),
        ("delete_to_match", length),
        ("delete_to_delete", length - 1),
        ("left_flank_loop", 1),
        ("left_flank_exit", 1),
        ("unannotated_segment_loop", 1),
        ("unannotated_segment_exit", 1),
        ("right_flank_loop", 1),
        ("right_flank_exit", 1),
        ("end_to_unannotated_segment", 1),
        ("end_to_right_flank", 1),
        ("end_to_terminal", 1),
    ]


def implicit_transition_parts(length):
    return [
        ("left_flank_loop", 1),
        ("left_flank_to_match", length),
        ("left_flank_to_right_flank", 1),
        ("left_flank_to_unannotated_segment", 1),
        ("left_flank_to_terminal", 1),
        ("match_to_match", length - 1),
        ("match_skip", (length - 1) * (length - 2) // 2),
        ("match_to_unannotated", length),
        ("match_to_right_flank", length),
        ("match_to_terminal", length),
        ("match_to_insert", length - 1),
        ("insert_to_match", length - 1),
        ("insert_to_insert", length - 1),
        ("unannotated_segment_to_match", length),
        ("unannotated_segment_loop", 1),
        ("unannotated_segment_to_right_flank", 1),
        ("unannotated_segment_to_terminal", 1),
        ("right_flank_loop", 1),
        ("right_flank_exit", 1),
        ("terminal_self_loop", 1),
    ]


def sparse_transition_indices_implicit(length):
    """(from, to) index arrays per implicit part."""
    a = np.arange(length + 1, dtype=np.int64)
    left_flank = 0
    first_insert = length + 1
    unanno = 2 * length
    right_flank = 2 * length + 1
    terminal = 2 * length + 2
    zeros = np.zeros(length, dtype=np.int64)
    return {
        "left_flank_loop": np.asarray([[left_flank, left_flank]]),
        "left_flank_to_match": np.stack([zeros + left_flank, a[1:]], axis=1),
        "left_flank_to_right_flank": np.asarray([[left_flank, right_flank]]),
        "left_flank_to_unannotated_segment": np.asarray([[left_flank, unanno]]),
        "left_flank_to_terminal": np.asarray([[left_flank, terminal]]),
        "match_to_match": np.stack([a[1:-1], a[1:-1] + 1], axis=1),
        "match_skip": (
            np.concatenate(
                [
                    np.stack([zeros[: -i - 1] + i, np.arange(i + 2, length + 1)], axis=1)
                    for i in range(1, length - 1)
                ],
                axis=0,
            )
            if length > 2
            else np.zeros((0, 2), np.int64)
        ),
        "match_to_unannotated": np.stack([a[1:], zeros + unanno], axis=1),
        "match_to_right_flank": np.stack([a[1:], zeros + right_flank], axis=1),
        "match_to_terminal": np.stack([a[1:], zeros + terminal], axis=1),
        "match_to_insert": np.stack([a[1:-1], a[:-2] + first_insert], axis=1),
        "insert_to_match": np.stack([a[:-2] + first_insert, a[2:]], axis=1),
        "insert_to_insert": np.stack([a[:-2] + first_insert] * 2, axis=1),
        "unannotated_segment_to_match": np.stack([zeros + unanno, a[1:]], axis=1),
        "unannotated_segment_loop": np.asarray([[unanno, unanno]]),
        "unannotated_segment_to_right_flank": np.asarray([[unanno, right_flank]]),
        "unannotated_segment_to_terminal": np.asarray([[unanno, terminal]]),
        "right_flank_loop": np.asarray([[right_flank, right_flank]]),
        "right_flank_exit": np.asarray([[right_flank, terminal]]),
        "terminal_self_loop": np.asarray([[terminal, terminal]]),
    }


def sparse_transition_indices_explicit(length):
    """(from, to) index arrays per explicit part."""
    a = np.arange(length + 1, dtype=np.int64)
    left_flank = 0
    first_insert = length + 1
    unanno = 2 * length
    right_flank = 2 * length + 1
    terminal = 2 * length + 2
    begin = 2 * length + 3
    end = 2 * length + 4
    first_delete = 2 * length + 5
    zeros = np.zeros(length, dtype=np.int64)
    return {
        "begin_to_match": np.stack([zeros + begin, a[1:]], axis=1),
        "match_to_end": np.stack([a[1:], zeros + end], axis=1),
        "match_to_match": np.stack([a[1:-1], a[1:-1] + 1], axis=1),
        "match_to_insert": np.stack([a[1:-1], a[:-2] + first_insert], axis=1),
        "insert_to_match": np.stack([a[:-2] + first_insert, a[2:]], axis=1),
        "insert_to_insert": np.stack([a[:-2] + first_insert] * 2, axis=1),
        "match_to_delete": np.stack([np.insert(a[1:-1], 0, begin), a[:-1] + first_delete], axis=1),
        "delete_to_match": np.stack([a[:-1] + first_delete, np.append(a[:-2] + 2, end)], axis=1),
        "delete_to_delete": np.stack([a[:-2] + first_delete, a[:-2] + first_delete + 1], axis=1),
        "left_flank_loop": np.asarray([[left_flank, left_flank]]),
        "left_flank_exit": np.asarray([[left_flank, begin]]),
        "unannotated_segment_loop": np.asarray([[unanno, unanno]]),
        "unannotated_segment_exit": np.asarray([[unanno, begin]]),
        "right_flank_loop": np.asarray([[right_flank, right_flank]]),
        "right_flank_exit": np.asarray([[right_flank, terminal]]),
        "end_to_unannotated_segment": np.asarray([[end, unanno]]),
        "end_to_right_flank": np.asarray([[end, right_flank]]),
        "end_to_terminal": np.asarray([[end, terminal]]),
    }


# Kernel parts that share one parameter vector.
_SHARED_KERNELS = [
    ["right_flank_loop", "left_flank_loop"],
    ["right_flank_exit", "left_flank_exit"],
]


def _canonical_name(part_name):
    for group in _SHARED_KERNELS:
        if part_name in group:
            return group[0]
    return part_name


def _logaddexp(x, y):
    # Both arguments are finite: probabilities are clamped at 1e-32 before
    # the log and the padding is LOG_ZERO, never -inf, so the gradient of
    # torch.logaddexp (NaN where both arguments are -inf) stays finite.
    return torch.logaddexp(x, y)


def _per_model(value, num_models, is_single):
    return [value] * num_models if is_single(value) else list(value)


class ProfileTransitions(nn.Module):
    """Plan7 profile-HMM transition model for one or more models.

    Args:
        lengths: model length (number of match states) or list of lengths.
        transition_init: dict (or list of dicts, one per model) mapping
            explicit edge-type names to initializers
            ``f(generator, shape)`` (:mod:`.initializers`).
        flank_init: initializer (or list) for the left-flank initial logit.
        prior: transition prior; defaults to :class:`ProfileHMMTransitionPrior`.
        frozen_kernels: dict ``{part_name: True}`` marking parts left out of
            training (``requires_grad=False``); any member of a shared
            group freezes the shared kernel.
        structured_forward: route the layer's sequential log-likelihood
            (and so the MAP loss) through the structured O(L) Plan7 matvec
            (:mod:`hmm_layer_torch.ops.plan7`) instead of the dense engine.
        generator: ``torch.Generator`` feeding the random initializers.
    """

    def __init__(
        self,
        lengths,
        transition_init=None,
        flank_init=None,
        prior=None,
        frozen_kernels=None,
        structured_forward: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.structured_forward = structured_forward
        self.lengths = [int(lengths)] if np.isscalar(lengths) else [int(l) for l in lengths]
        self.num_models = len(self.lengths)
        self.num_states = get_num_states(self.lengths)
        self.num_states_explicit = get_num_states_implicit(self.lengths)
        self.max_num_states = max(self.num_states)
        if transition_init is None:
            transition_init = inits.make_default_transition_init()
        self.transition_init = _per_model(
            transition_init, self.num_models, lambda v: isinstance(v, dict)
        )
        if flank_init is None:
            flank_init = inits.make_default_flank_init()
        self.flank_init = _per_model(flank_init, self.num_models, lambda v: not isinstance(v, list))
        self.prior = ProfileHMMTransitionPrior() if prior is None else prior
        self.frozen_kernels = frozen_kernels or {}
        assert len(self.transition_init) == self.num_models
        assert len(self.flank_init) == self.num_models

        self.explicit_parts = [explicit_transition_kernel_parts(l) for l in self.lengths]
        self.implicit_parts = [implicit_transition_parts(l) for l in self.lengths]
        self.indices_explicit = [sparse_transition_indices_explicit(l) for l in self.lengths]
        self.indices_implicit = [sparse_transition_indices_implicit(l) for l in self.lengths]
        for init, parts in zip(self.transition_init, self.explicit_parts):
            for name, _ in parts:
                assert name in init, f"no initializer for kernel part {name}"
        # Host index arrays, concatenated in part order, and their
        # per-device tensors (made on first use on each device).
        self._explicit_concat = [
            np.concatenate([idx[name] for name, _ in parts], axis=0)
            for idx, parts in zip(self.indices_explicit, self.explicit_parts)
        ]
        self._implicit_concat = [
            np.concatenate([idx[name] for name, _ in parts], axis=0)
            for idx, parts in zip(self.indices_implicit, self.implicit_parts)
        ]
        self._device_arrays = {}

        frozen = self._frozen_canonical()
        kernels, flank = self._draw(generator)
        self.kernels = nn.ModuleList(
            nn.ParameterDict(
                {name: nn.Parameter(v, requires_grad=name not in frozen) for name, v in model.items()}
            )
            for model in kernels
        )
        self.flank_init_kernel = nn.ParameterList(nn.Parameter(v) for v in flank)

    # -- params ----------------------------------------------------------------

    def _frozen_canonical(self):
        return {_canonical_name(name) for name, frozen in self.frozen_kernels.items() if frozen}

    def _draw(self, generator):
        """Fresh kernels from the initializers: per model, its parts in
        order (a shared part once), then the flank logits."""
        kernels = []
        for init, parts in zip(self.transition_init, self.explicit_parts):
            model = {}
            for name, length in parts:
                canon = _canonical_name(name)
                if canon not in model:
                    model[canon] = init[name](generator, (length,)).to(torch.float32)
            kernels.append(model)
        flank = [fn(generator, (1,)).to(torch.float32) for fn in self.flank_init]
        return kernels, flank

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Every kernel back to its initializer's value, the random ones
        drawn from ``generator`` (the JAX ``init_params``)."""
        kernels, flank = self._draw(generator)
        for pdict, model in zip(self.kernels, kernels):
            for name, value in model.items():
                pdict[name].copy_(value)
        for p, value in zip(self.flank_init_kernel, flank):
            p.copy_(value)

    def _device(self):
        return self.flank_init_kernel[0].device

    def _index(self, key, build):
        """A host array made by ``build()`` as a tensor on the module's
        device, cached per device (made outside inference mode, so that a
        first call under ``torch.inference_mode`` does not leave a tensor
        that autograd may not save)."""
        device = self._device()
        if (key, device) not in self._device_arrays:
            with torch.inference_mode(False):
                self._device_arrays[(key, device)] = torch.as_tensor(build(), device=device)
        return self._device_arrays[(key, device)]

    def _set_kernels(self, kernels, flank, share: bool = False):
        """Replace every parameter with the given tensors: the parameters
        themselves (``share``) or copies keeping each one's
        ``requires_grad``."""
        def param(value, like):
            if share:
                return value
            return nn.Parameter(value.detach().clone(), requires_grad=like.requires_grad)

        for pdict, model in zip(self.kernels, kernels):
            for name, value in model.items():
                pdict[name] = param(value, pdict[name])
        for i, value in enumerate(flank):
            self.flank_init_kernel[i] = param(value, self.flank_init_kernel[i])

    def duplicate(self, model_indices=None, share_kernels: bool = False):
        """A module holding the models ``model_indices`` (default: all),
        their kernels the same tensors (``share_kernels``) or copies; the
        model-surgery hook of :func:`~hmm_layer_torch.training.select_models`."""
        if model_indices is None:
            model_indices = list(range(self.num_models))
        copy = ProfileTransitions(
            [self.lengths[i] for i in model_indices],
            transition_init=[self.transition_init[i] for i in model_indices],
            flank_init=[self.flank_init[i] for i in model_indices],
            prior=self.prior,
            frozen_kernels=self.frozen_kernels,
            structured_forward=self.structured_forward,
        ).to(self._device())
        kernels = [dict(self.kernels[i].items()) for i in model_indices]
        flank = [self.flank_init_kernel[i] for i in model_indices]
        copy._set_kernels(kernels, flank, share=share_kernels)
        return copy

    # -- param-preserving length adaptation ---------------------------------------

    @staticmethod
    def _resize_keep(old_lengths, new_lengths, keep):
        """Normalise/validate the per-model new-column -> old-column maps.

        Each map is an int array of length ``new_length``: entry ``j`` is
        the old match column (0-based) surviving at new position ``j``, or
        ``-1`` for a fresh column. Non-negative entries must be strictly
        increasing (columns keep their order). Default: identity prefix
        (grow/shrink at the model's end).
        """
        if keep is None:
            keep = []
            for lo, ln in zip(old_lengths, new_lengths):
                k = np.full(ln, -1, np.int64)
                n = min(lo, ln)
                k[:n] = np.arange(n)
                keep.append(k)
            return keep
        keep = [np.asarray(k, np.int64) for k in keep]
        for i, (k, lo, ln) in enumerate(zip(keep, old_lengths, new_lengths)):
            if k.shape != (ln,):
                raise ValueError(f"keep[{i}] has shape {k.shape}, expected ({ln},)")
            kept = k[k >= 0]
            if kept.size and (kept.max() >= lo or np.any(np.diff(kept) <= 0)):
                raise ValueError(
                    f"keep[{i}] must map to old columns < {lo} in strictly "
                    f"increasing order; got {k.tolist()}"
                )
        return keep

    # Entry-index semantics of the explicit kernel parts, used to carry
    # trained values across a resize. "col": entry j belongs to match
    # column j. "pair": entry j belongs to consecutive columns (j, j+1).
    # "mtd": match_to_delete, entry j is the edge (column j-1 | BEGIN) ->
    # delete shadow of column j. "dtm": delete_to_match, entry j is the
    # edge delete(j) -> (column j+1 | END).
    _RESIZE_PART_KINDS = {
        "begin_to_match": "col",
        "match_to_end": "col",
        "match_to_match": "pair",
        "match_to_insert": "pair",
        "insert_to_match": "pair",
        "insert_to_insert": "pair",
        "match_to_delete": "mtd",
        "delete_to_match": "dtm",
        "delete_to_delete": "pair",
    }

    @staticmethod
    def _resize_entry_map(kind, k, old_length):
        """(new_idx, old_idx) entry pairs preserved by the column map ``k``."""
        ln = len(k)
        new_idx, old_idx = [], []
        if kind == "col":
            for j in range(ln):
                if k[j] >= 0:
                    new_idx.append(j)
                    old_idx.append(int(k[j]))
        elif kind == "pair":
            for j in range(ln - 1):
                if k[j] >= 0 and k[j + 1] == k[j] + 1:
                    new_idx.append(j)
                    old_idx.append(int(k[j]))
        elif kind == "mtd":
            if ln and k[0] == 0:  # BEGIN -> delete(0) survives iff col 0 does
                new_idx.append(0)
                old_idx.append(0)
            for j in range(1, ln):
                if k[j - 1] >= 0 and k[j] == k[j - 1] + 1:
                    new_idx.append(j)
                    old_idx.append(int(k[j]))
        elif kind == "dtm":
            for j in range(ln - 1):
                if k[j] >= 0 and k[j + 1] == k[j] + 1:
                    new_idx.append(j)
                    old_idx.append(int(k[j]))
            if ln and k[ln - 1] == old_length - 1:  # delete(last) -> END
                new_idx.append(ln - 1)
                old_idx.append(old_length - 1)
        else:  # pragma: no cover
            raise AssertionError(kind)
        return np.asarray(new_idx, np.int64), np.asarray(old_idx, np.int64)

    @torch.no_grad()
    def resize(self, new_lengths, keep=None, generator: torch.Generator | None = None):
        """Param-preserving re-target to new model lengths (learnMSA's
        iterative length adaptation): the trained logits of every surviving
        edge carry over, and only edges touching *new* columns take fresh
        initializer values, drawn from ``generator``.

        Args:
            new_lengths: new match-state count per model (scalar or list of
                ``num_models`` ints).
            keep: optional per-model maps new column -> old column (see
                :meth:`_resize_keep`); default grows/shrinks at the model
                end.

        Returns:
            a new :class:`ProfileTransitions` on this module's device.
        """
        if np.isscalar(new_lengths):
            new_lengths = [new_lengths]
        new_lengths = [int(l) for l in new_lengths]
        if len(new_lengths) != self.num_models:
            raise ValueError(f"{len(new_lengths)} new lengths for {self.num_models} models")
        keep = self._resize_keep(self.lengths, new_lengths, keep)
        new_model = ProfileTransitions(
            new_lengths,
            transition_init=self.transition_init,
            flank_init=self.flank_init,
            prior=self.prior,
            frozen_kernels=self.frozen_kernels,
            structured_forward=self.structured_forward,
        ).to(self._device())
        fresh, _ = new_model._draw(generator)
        kernels = []
        for i, lo in enumerate(self.lengths):
            old_kernel = self.kernels[i]
            new_kernel = {}
            for canon, vec in fresh[i].items():
                kind = self._RESIZE_PART_KINDS.get(canon)
                if kind is None:  # scalar flank/segment parts: copy
                    vec = old_kernel[canon].detach()
                else:
                    vec = vec.to(old_kernel[canon].device)
                    new_idx, old_idx = self._resize_entry_map(kind, keep[i], lo)
                    if new_idx.size:
                        vec[torch.as_tensor(new_idx)] = old_kernel[canon].detach()[torch.as_tensor(old_idx)]
                new_kernel[canon] = vec
            kernels.append(new_kernel)
        new_model._set_kernels(kernels, list(self.flank_init_kernel))
        return new_model

    def trainable_mask(self) -> dict:
        """The JAX trainable-mask tree: ``False`` for frozen kernels."""
        return {
            "kernels": [{name: p.requires_grad for name, p in pdict.items()} for pdict in self.kernels],
            "flank_init_kernel": [p.requires_grad for p in self.flank_init_kernel],
        }

    def _kernel_for(self, i, name):
        return self.kernels[i][_canonical_name(name)]

    # -- probability construction ------------------------------------------------

    def make_probs(self):
        """Per-model dict of per-edge-type probabilities over the explicit
        model (per-row softmax on the sparse pattern)."""
        out = []
        for i, (parts, n_exp) in enumerate(zip(self.explicit_parts, self.num_states_explicit)):
            idx = self._index(("explicit", i), lambda: self._explicit_concat[i])
            mask = self._index(("explicit_mask", i), lambda: self._dense_mask(i, n_exp))
            values = torch.cat([self._kernel_for(i, name) for name, _ in parts], dim=0)
            dense = torch.full((n_exp, n_exp), LOG_ZERO, dtype=values.dtype, device=values.device)
            dense = dense.index_put((idx[:, 0], idx[:, 1]), torch.clamp_min(values, LOG_ZERO + 1.0))
            probs = torch.exp(dense - dense.amax(-1, keepdim=True)) * mask
            probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-16)
            vec = probs[idx[:, 0], idx[:, 1]]
            model_probs, offset = {}, 0
            for name, length in parts:
                model_probs[name] = vec[offset : offset + length]
                offset += length
            out.append(model_probs)
        return out

    def _dense_mask(self, i, n_exp):
        idx = self._explicit_concat[i]
        mask = np.zeros((n_exp, n_exp), np.float32)
        mask[idx[:, 0], idx[:, 1]] = 1.0
        return mask

    def make_implicit_log_probs(self):
        """Silent-state elimination; returns (implicit, log_probs, probs)."""
        probs = self.make_probs()
        log_probs = [{k: torch.log(torch.clamp_min(v, 1e-32)) for k, v in mp.items()} for mp in probs]
        implicit = []
        for i, (p, length) in enumerate(zip(log_probs, self.lengths)):
            MD = p["match_to_delete"][:, None]  # (L, 1)
            zero = MD.new_zeros(1)
            log_zero = MD.new_full((1,), LOG_ZERO)
            DD = torch.cat([zero, p["delete_to_delete"]], dim=0)
            cs = torch.cumsum(DD, dim=0)
            DDm = cs[None, :] - cs[:, None]  # (L, L): sum of DD on the (i, j) path
            DM = p["delete_to_match"][None, :]
            M_skip = MD + DDm + DM  # (L, L); begin = M0, end = M(L+1)
            entry_add = _logaddexp(p["begin_to_match"], torch.cat([log_zero, M_skip[0, :-1]], dim=0))
            exit_add = _logaddexp(p["match_to_end"], torch.cat([M_skip[1:, -1], log_zero], dim=0))
            skip_all = M_skip[0, -1]
            imp = {
                "match_to_match": p["match_to_match"],
                "match_to_insert": p["match_to_insert"],
                "insert_to_match": p["insert_to_match"],
                "insert_to_insert": p["insert_to_insert"],
                "left_flank_loop": p["left_flank_loop"],
                "right_flank_loop": p["right_flank_loop"],
                "right_flank_exit": p["right_flank_exit"],
            }
            if length > 2:
                rows, cols = self._index(("triu", i), lambda: np.stack(np.triu_indices(length - 2)))
                imp["match_skip"] = M_skip[1:-1, 1:-1][rows, cols]
            else:
                imp["match_skip"] = MD.new_zeros(0)
            imp["left_flank_to_match"] = p["left_flank_exit"] + entry_add
            imp["left_flank_to_right_flank"] = p["left_flank_exit"] + skip_all + p["end_to_right_flank"]
            imp["left_flank_to_unannotated_segment"] = (
                p["left_flank_exit"] + skip_all + p["end_to_unannotated_segment"]
            )
            imp["left_flank_to_terminal"] = p["left_flank_exit"] + skip_all + p["end_to_terminal"]
            imp["match_to_unannotated"] = exit_add + p["end_to_unannotated_segment"]
            imp["match_to_right_flank"] = exit_add + p["end_to_right_flank"]
            imp["match_to_terminal"] = exit_add + p["end_to_terminal"]
            imp["unannotated_segment_to_match"] = p["unannotated_segment_exit"] + entry_add
            imp["unannotated_segment_loop"] = _logaddexp(
                p["unannotated_segment_loop"],
                p["unannotated_segment_exit"] + skip_all + p["end_to_unannotated_segment"],
            )
            imp["unannotated_segment_to_right_flank"] = (
                p["unannotated_segment_exit"] + skip_all + p["end_to_right_flank"]
            )
            imp["unannotated_segment_to_terminal"] = (
                p["unannotated_segment_exit"] + skip_all + p["end_to_terminal"]
            )
            imp["terminal_self_loop"] = zero
            implicit.append(imp)
        return implicit, log_probs, probs

    def make_log_A(self):
        """(num_models, q_max, q_max) dense log transition matrix, padded
        with ``LOG_ZERO``."""
        return self._log_A(self.make_implicit_log_probs()[0])

    def _log_A(self, implicit):
        q = self.max_num_states
        rows = []
        for i, (imp, parts) in enumerate(zip(implicit, self.implicit_parts)):
            idx = self._index(("implicit", i), lambda: self._implicit_concat[i])
            values = torch.cat([imp[name] for name, _ in parts], dim=0)
            log_A = torch.full((q, q), LOG_ZERO, dtype=values.dtype, device=values.device)
            rows.append(log_A.index_put((idx[:, 0], idx[:, 1]), values))
        return torch.stack(rows, dim=0)

    def make_log_A_sparse(self):
        """Per-model COO views of the implicit transition matrix: a list of
        ``(indices (n_i, 2) numpy, log_values (n_i,))``, the edges in the
        order of :func:`sparse_transition_indices_implicit`. Profile state
        spaces are small (2L+3), so this gathers from the dense build."""
        log_A = self.make_log_A()
        out = []
        for i, parts in enumerate(self.indices_implicit):
            idx = np.concatenate(list(parts.values()), axis=0)
            rows, cols = self._index(("implicit_coo", i), lambda: idx.T.copy())
            out.append((idx, log_A[i, rows, cols]))
        return out

    def make_A_sparse(self):
        """Linear-space COO views; the layout of :meth:`make_log_A_sparse`."""
        return [(idx, torch.exp(vals)) for idx, vals in self.make_log_A_sparse()]

    def make_A(self):
        return torch.exp(self.make_log_A())

    def make_flank_init_prob(self):
        return torch.sigmoid(torch.stack([k[0] for k in self.flank_init_kernel]))  # (m,)

    def make_initial_distribution(self):
        """(num_models, q_max) initial distribution."""
        return self._initial_distribution(*self.make_implicit_log_probs()[:2])

    def _initial_distribution(self, implicit, log_probs):
        flank_prob = self.make_flank_init_prob()
        log_flank = torch.log(flank_prob)
        log_compl = torch.log1p(-flank_prob)
        rows = []
        for i, (imp, lp, length) in enumerate(zip(implicit, log_probs, self.lengths)):
            corr = log_compl[i] - lp["left_flank_exit"]
            pad = self.max_num_states - self.num_states[i]
            log_init = torch.cat(
                [
                    log_flank[i][None],
                    imp["left_flank_to_match"] + corr,
                    log_flank.new_full((length - 1,), LOG_ZERO),
                    imp["left_flank_to_unannotated_segment"] + corr,
                    imp["left_flank_to_right_flank"] + corr,
                    imp["left_flank_to_terminal"] + corr,
                    log_flank.new_full((pad,), LOG_ZERO),
                ],
                dim=0,
            )
            rows.append(log_init)
        return torch.exp(torch.stack(rows, dim=0))

    def matrices(self):
        """(init (m, q_max), A (m, q_max, q_max)), from one silent-state
        elimination."""
        implicit, log_probs, _ = self.make_implicit_log_probs()
        return self._initial_distribution(implicit, log_probs), torch.exp(self._log_A(implicit))

    def prior_log_density(self):
        """(num_models,) summed transition prior."""
        prior = self.prior(self.make_probs(), self.make_flank_init_prob())
        return sum(prior.values())

    # -- config -------------------------------------------------------------------

    def get_config(self):
        """Full JSON-able config, the JAX package's: initializers as their
        specs (:func:`~.initializers.init_to_config`)."""
        return {
            "lengths": self.lengths,
            "frozen_kernels": self.frozen_kernels,
            "structured_forward": self.structured_forward,
            "transition_init": [
                {name: inits.init_to_config(fn) for name, fn in model_init.items()}
                for model_init in self.transition_init
            ],
            "flank_init": [inits.init_to_config(fn) for fn in self.flank_init],
            "prior": self.prior.get_config(),
        }

    @classmethod
    def from_config(cls, config):
        t_init = config.get("transition_init")
        if t_init is not None:
            t_init = [{name: inits.init_from_config(spec) for name, spec in mi.items()} for mi in t_init]
        f_init = config.get("flank_init")
        if f_init is not None:
            f_init = [inits.init_from_config(spec) for spec in f_init]
        prior = config.get("prior")
        if prior is not None:
            prior = ProfileHMMTransitionPrior.from_config(prior)
        return cls(
            config["lengths"],
            transition_init=t_init,
            flank_init=f_init,
            prior=prior,
            frozen_kernels=config.get("frozen_kernels"),
            structured_forward=config.get("structured_forward", False),
        )
