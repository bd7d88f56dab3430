"""Gradient-based training for HMM layers (port of
``hmm_layer_tpu/training.py``).

:class:`Trainer` runs ``torch.optim`` steps over an
:class:`~hmm_layer_torch.layer.HMMLayer` with

* frozen parameters: a parameter with ``requires_grad=False`` (set from the
  components' ``*_trainable`` flags, the JAX ``trainable_mask``) is left
  out of the optimizer, as the JAX trainer routes it to
  ``optax.set_to_zero``;
* gradient accumulation over micro-batches
  (:func:`microbatched_value_and_grad`);
* periodic checkpoints holding the parameters and the optimizer state
  (:mod:`hmm_layer_torch.utils.checkpoint`) and JSON-lines metrics.

The layer owns its parameters, so where the JAX trainer threads
``(params, opt_state)`` through its calls, this one updates the layer in
place and keeps the optimizer.

Multi-device training: a layer built with ``mesh``/``partition`` trains
through its sharded routes as it is (every rank gets the whole batch and
the whole-batch gradient); ``Trainer(mesh=..., data_axis=...)`` gives a
layer without a partition the data-parallel route ``{"batch": data_axis}``
on that mesh. Either way every rank starts from rank 0's parameters and
takes the same optimizer step; rank 0 alone writes metrics and
checkpoints.

A layer with a ``state`` or ``seq`` partition (or ``batch``) trains in its
rank-local mode through ``loss_fn``, e.g. ``loss_fn=lambda batch, indices:
layer.loss(batch, indices=indices, local=True)``: each rank computes only
its block of the emissions, and the step's reductions are the layer's own,
so that every rank gets the whole batch's loss and gradients:

* the emitters' parameters: their gradients, each rank's block's share,
  summed over the route's axes and the data axis (one all-reduce);
* ``init`` and ``A`` (or the edge probabilities): global already, from the
  sharded functions' backward, and not summed again;
* the CE objective: its partial sums summed over the ranks once, for the
  value; its gradient is the sharded function's VJP alone;
* the MAP loss: the log-likelihood is the same on the ranks of a
  ``state`` or ``seq`` axis, its rows' mean summed over the data axis;
  the prior and the auxiliary loss are computed whole on every rank.
"""

from __future__ import annotations

import inspect
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from .layer import HMMLayer
from .utils import checkpoint as ckpt
from .utils.metrics import MetricsLogger, Throughput
from .utils.profiling import span
from .utils.resilience import HangWatchdog

__all__ = [
    "Trainer",
    "make_frozen_mask",
    "microbatched_value_and_grad",
    "select_models",
    "FitSelectResult",
]


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


@span("hmm.train.backward")
def _grads(loss, params):
    """d loss / d params, zeros for a parameter the loss does not use (as
    ``jax.grad`` gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def select_models(component, indices):
    """A copy of a transition or emission component holding only the
    models ``indices``.

    A component whose ``duplicate`` takes ``model_indices`` (the profile
    family, whose per-model parameters differ in length) does the surgery
    itself. Any other is rebuilt from its config with the new
    ``num_models``, each parameter whose leading axis carries the model
    count sliced to ``indices`` (parameters without a model axis, e.g. the
    shared gene-pred transition kernel, are copied)."""
    duplicate = getattr(component, "duplicate", None)
    if duplicate is not None and "model_indices" in inspect.signature(duplicate).parameters:
        return duplicate(model_indices=list(indices))
    n = getattr(component, "num_models", 1)
    config = component.get_config()
    if "num_models" in config:
        config["num_models"] = len(indices)
    copy = type(component).from_config(config)
    index = torch.as_tensor(list(indices))
    for name, param in component.named_parameters():
        value = param.detach()
        value = value[index.to(value.device)] if value.dim() and value.shape[0] == n else value
        owner, _, leaf = name.rpartition(".")
        setattr(
            copy.get_submodule(owner),
            leaf,
            torch.nn.Parameter(value.clone(), requires_grad=param.requires_grad),
        )
    return copy


def microbatched_value_and_grad(loss_fn: Callable, params, batch, micro: int):
    """Gradient accumulation over the sequence-batch axis (axis 1).

    Computes ``mean_k loss_fn(batch[:, k*micro:(k+1)*micro])`` and its
    gradient with respect to ``params`` one micro-batch at a time, so the
    peak residual memory is one micro-batch's worth instead of the whole
    batch's.

    EXACT for objectives that are UNWEIGHTED means over the batch axis
    plus batch-independent terms (the MAP loss's scaled prior and the
    unmasked CE loss qualify: the mean over equal-size chunks averages to
    the full-batch mean, and the prior/aux terms appear once in the mean).
    NOT exact for per-batch-normalised weighted aggregates —
    ``sum(w*ll)/sum(w)`` or a ``label_mask``-normalised CE computed per
    chunk averages with uniform 1/k weights, which differs whenever chunk
    weight/mask sums differ (and can even flip gradient signs). For those,
    normalise inside ``loss_fn`` by the FULL-batch weight/mask sum (a
    constant you close over), not the chunk's own sum.

    Args:
        loss_fn: ``loss_fn(micro_batch) -> scalar`` tensor.
        params: the tensors to differentiate with respect to.
        batch: tensor or nested dicts/lists/tuples of tensors or arrays
            shaped ``(m, b, ...)``; ``b`` must be divisible by ``micro``.
        micro: sequences per micro-batch.

    Returns:
        ``(loss, grads)``: the full-batch mean objective (detached) and its
        gradient, one tensor per parameter (zeros where unused).
    """
    params = list(params)
    b = _first_leaf(batch).shape[1]
    if b % micro:
        raise ValueError(f"batch axis ({b}) must be divisible by microbatch ({micro})")
    k = b // micro
    loss_sum, grad_sum = 0.0, [torch.zeros_like(p) for p in params]
    for i in range(k):
        part = _tree_map(lambda leaf: leaf[:, i * micro : (i + 1) * micro], batch)
        loss = loss_fn(part)
        grads = _grads(loss, params)
        loss_sum = loss_sum + loss.detach()
        for acc, g in zip(grad_sum, grads):
            acc += g
    return loss_sum / k, [g / k for g in grad_sum]


class FitSelectResult(NamedTuple):
    """Result of :meth:`Trainer.fit_select`."""

    loss: torch.Tensor  # last training loss of the joint layer
    scores: np.ndarray  # (num_models,) mean per-model log-likelihood
    ranking: np.ndarray  # model indices, best first
    layer: HMMLayer  # layer holding only the kept model(s) and their params


def make_frozen_mask(layer: HMMLayer) -> dict[str, bool]:
    """``state_dict`` name -> trainable (the parameter's ``requires_grad``)."""
    return {name: p.requires_grad for name, p in layer.named_parameters()}


def _default_optimizer(params):
    return torch.optim.Adam(params, lr=1e-2)


class Trainer:
    """MAP (or custom-objective) trainer for an :class:`HMMLayer`.

    Args:
        layer: the HMM layer; its parameters are trained in place.
        optimizer: factory ``params -> torch.optim.Optimizer`` over the
            trainable parameters, e.g. ``functools.partial(torch.optim.SGD,
            lr=0.1)``; default Adam(1e-2), the JAX default
            ``optax.adam(1e-2)``.
        mesh / data_axis: data-parallel training of a layer that has no
            partition: the layer takes ``partition={"batch": data_axis}``
            on ``mesh`` (a :class:`hmm_layer_torch.parallel.Mesh`). A layer
            with its own mesh and partition needs neither.
        checkpoint_dir: if set, checkpoints every ``checkpoint_every`` steps.
        metrics_path: JSON-lines file of the logged metrics.
        loss_fn: objective override ``loss_fn(batch, indices) -> scalar``;
            ``batch`` is whatever the fit iterable yields (e.g. ``{"x":
            ..., "labels": ..., "mask": ...}`` for the supervised
            posterior cross-entropy). Default: ``layer.loss`` (MAP).
        microbatch: compute each step's gradient in micro-batches of this
            many sequences (batch axis 1) and average — identical objective
            for unweighted means (:func:`microbatched_value_and_grad`).
    """

    def __init__(
        self,
        layer: HMMLayer,
        optimizer: Callable | None = None,
        mesh=None,
        data_axis: str = "data",
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 100,
        metrics_path: str | None = None,
        loss_fn: Callable | None = None,
        microbatch: int | None = None,
    ):
        if mesh is not None:
            if layer.mesh is None:
                if data_axis not in mesh.shape:
                    raise ValueError(
                        f"partition 'batch' -> {data_axis!r} is not an axis of the "
                        f"mesh (axes: {dict(mesh.shape)})"
                    )
                layer.mesh, layer.partition = mesh, {"batch": data_axis}
            elif layer.mesh is not mesh:
                raise ValueError("the layer already has another mesh; pass mesh=None to train on the layer's")
        self.mesh = layer.mesh
        if self.mesh is not None:
            from .parallel import replicate

            replicate(layer, self.mesh)  # every rank starts from rank 0's parameters
        self.writer = self.mesh is None or self.mesh.rank == 0
        self.layer = layer
        self.loss_fn = loss_fn
        self.make_optimizer = optimizer or _default_optimizer
        self.checkpoint_dir = checkpoint_dir if self.writer else None
        self.checkpoint_every = checkpoint_every
        self.microbatch = microbatch
        self.metrics = MetricsLogger(metrics_path if self.writer else None)
        self.optimizer = None

    def init(self, seed: int | torch.Generator | None = None, input_dim: int | None = None):
        """Re-initialise the layer's parameters (transition noise from
        ``seed``, emission kernels ``input_dim`` wide) and return a fresh
        optimizer over them."""
        generator = torch.Generator().manual_seed(seed) if isinstance(seed, int) else seed
        self.layer.reset_parameters(generator, input_dim)
        return self.init_from_params()

    def init_from_params(self):
        """A fresh optimizer over the layer's trainable parameters as they
        are — after a checkpoint load, or after model surgery."""
        self.optimizer = self.make_optimizer(self._trainable())
        return self.optimizer

    def _trainable(self):
        return [p for p in self.layer.parameters() if p.requires_grad]

    @span("hmm.train.forward")
    def _objective(self, batch, indices):
        if self.loss_fn is not None:
            return self.loss_fn(batch, indices)
        return self.layer.loss(batch, indices=indices)

    @span("hmm.train.step")
    def _step(self, batch, indices):
        params = self._trainable()
        if self.microbatch:
            if indices is not None:
                raise ValueError(
                    "Trainer(microbatch=...) does not compose with "
                    "sequence-weight indices: the full-batch index array "
                    "cannot be applied to a micro-chunk's logliks, and a "
                    "per-chunk weighted mean would average WRONGLY (uniform "
                    "1/k chunk weights). Use a custom loss_fn that puts the "
                    "per-sequence weights into the batch AND normalises by "
                    "the full-batch weight sum (a constant), not the "
                    "chunk's own sum."
                )
            loss, grads = microbatched_value_and_grad(
                lambda part: self._objective(part, None), params, batch, self.microbatch
            )
        else:
            loss = self._objective(batch, indices)
            grads = _grads(loss, params)
            loss = loss.detach()
        with span("hmm.train.optimizer"):
            for p, g in zip(params, grads):
                p.grad = g
            self.optimizer.step()
            for p in params:
                p.grad = None
        return loss

    def fit(
        self,
        batches: Iterable,
        steps: int | None = None,
        log_every: int = 10,
        hang_timeout_s: float | None = None,
    ):
        """Train over an iterable of (m, b, L, s) batches (or (batch,
        indices) pairs when sequence weights are used); returns the last
        step's loss (a detached scalar tensor).

        ``hang_timeout_s`` arms a :class:`HangWatchdog` around each logged
        host sync: a wedged device step dumps thread stacks and raises
        RuntimeError, so an outer supervisor can restart from the latest
        checkpoint (:func:`hmm_layer_torch.utils.resilience.latest_checkpoint`).
        """
        if self.optimizer is None:
            self.init_from_params()
        watchdog = HangWatchdog(hang_timeout_s) if hang_timeout_s else None
        meter = Throughput()
        loss = None
        for step_idx, batch in enumerate(batches):
            if steps is not None and step_idx >= steps:
                break
            batch, indices = batch if isinstance(batch, tuple) else (batch, None)
            loss = self._step(batch, indices)
            # b sequences per step (each is scored by every model; models do
            # not multiply the count).
            meter.update(_first_leaf(batch).shape[1])
            if step_idx % log_every == 0:
                with span("hmm.train.log"):
                    if watchdog is not None:
                        with watchdog:
                            loss_val = float(loss)  # host sync
                        if watchdog.fired:
                            raise RuntimeError(
                                f"training step {step_idx} exceeded {hang_timeout_s}s "
                                "(stacks dumped); restart from the latest checkpoint"
                            )
                    else:
                        loss_val = float(loss)  # host sync
                    self.metrics.log(step_idx, loss=loss_val, seqs_per_sec=meter.seqs_per_sec)
            if self.checkpoint_dir and step_idx and step_idx % self.checkpoint_every == 0:
                # Full training state: parameters AND optimizer state, so a
                # resumed run continues with intact moments and counters.
                ckpt.save_checkpoint(
                    f"{self.checkpoint_dir}/step_{step_idx}.npz",
                    self.layer,
                    step=step_idx,
                    optimizer=self.optimizer,
                )
        return loss

    def restore(self, path: str):
        """Load a :meth:`fit` checkpoint into the layer and the optimizer
        (a fresh one first, if there is none); a parameters-only
        checkpoint loads the parameters and keeps the optimizer as it is.
        Returns the optimizer."""
        if self.optimizer is None:
            self.init_from_params()
        ckpt.load_checkpoint(path, self.layer, optimizer=self.optimizer)
        return self.optimizer

    @torch.no_grad()
    def score_models(self, batches: Iterable) -> np.ndarray:
        """Mean per-model log-likelihood over ``batches``; (num_models,)."""
        total, count = 0.0, 0
        for batch in batches:
            if isinstance(batch, tuple):
                batch = batch[0]
            total = total + self.layer.log_likelihood(batch).sum(1).cpu().numpy()
            count += batch.shape[1]
        return total / max(count, 1)

    def fit_select(
        self,
        batches: Iterable,
        score_batches: Iterable,
        steps: int | None = None,
        keep: int = 1,
        log_every: int = 10,
    ) -> FitSelectResult:
        """Train all models jointly, score them, keep the best ``keep``,
        carved out by :func:`select_models` into a new :class:`HMMLayer`."""
        loss = self.fit(batches, steps=steps, log_every=log_every)
        scores = self.score_models(score_batches)
        ranking = np.argsort(-scores)
        best = [int(i) for i in ranking[:keep]]
        layer = HMMLayer(
            select_models(self.layer.transitions, best),
            [select_models(em, best) for em in self.layer.emissions],
            num_seqs=self.layer.num_seqs,
            use_prior=self.layer.use_prior,
            sequence_weights=self.layer.sequence_weights,
            parallel_factor=self.layer.parallel_factor,
            device=self.layer.device,
            mesh=self.layer.mesh,
            partition=self.layer.partition or None,
        )
        return FitSelectResult(loss=loss, scores=scores, ranking=ranking, layer=layer)
