"""learnMSA's profile HMMs at learnMSA's own sizing in the port against the
benchmark's plain float64 reference (``portbench/reference/profile.py``)
on seeded weights: the five models of 318-322 match states (q = 639-647,
padded to 647) of the configuration ``learnmsa-profile-m5-n320``, at its
published widths and a tiny batch and length (b = 2, L = 24). On the CPU
the MAP step's passes are the plain loops; on the card K2c and K3c
(64 < q <= 704: above 512 their register cut).

Compared: each model's (init, A) after the delete states' elimination;
the MAP loss with the priors, its log-likelihood and prior parts; the port
in float64 against the reference exactly; the first ``Trainer.fit`` step's
gradient and the change after three Adam steps (``portbench.checks``'
readings); the spans and launches of one MAP step; one tiny run of the
cell through ``portbench.run.main``. The ``gpu`` test repeats the step's
checks on the card (``python -m pytest --noconftest -q
tests/test_torch_profile_n320_reference.py``; the file imports no JAX).

Tolerances (float32 program, float64 reference):

* ``A`` and ``init``: relative 1e-4 of each entry or of 1e-30, whichever is
  larger. The skip chains are exponentials of cumulative sums of up to
  n - 1 = 321 delete-to-delete log-probabilities of magnitude ~1, so
  float32 rounding reaches ~n x 2^-24 of the chain's log, 3e-5 of the
  entry (measured 2.8e-5-3.2e-5); chains below float32's range (~1e-141
  here) hold 0 in the port.
* Log-likelihoods: rtol 1e-6 (measured up to 1.9e-7 over 24 steps).
* The prior, scaled by 1 / num_seqs: three float32 spacings of the single-
  hit term (1e9 - 1) log(p_rf + p_t), whose sum lies just below 1, where a
  spacing (2^-24) moves the term by 60 nats (measured up to 1.4 spacings).
* The Adam readings: ``loss_rel`` 1e-3 (the prior's spacings above; the
  reference computed in plain float32 reads the same, 1e-4-3.2e-4);
  ``grad_norm_gap`` 1e-2 (the worst leaf is an end-to-terminal logit,
  whose gradient is the single-hit term's: 0.9e-3-1.9e-3, float32
  reference 1.7e-3-2.7e-3); ``grad_median_gap`` 1e-6 and
  ``update_norm_gap`` 5e-5, about ten times the program's largest
  readings (7.4e-8, 5.6e-6) and below the TF32 control's smallest
  (6e-6, 1.2e-4).
"""

import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hmm_layer_torch import Trainer, cli
from hmm_layer_torch.models import priors
from hmm_layer_torch.models.dirichlet import dirichlet_log_pdf
from hmm_layer_torch.ops import cuda_forward, recursion
from hmm_layer_torch.utils import profiling
from portbench import checks
from portbench.models import profile as fam
from portbench.reference import hmm
from portbench.reference import profile as ref
from portbench.reference.hmm import F64

ROOT = Path(__file__).resolve().parent.parent
CELL = "profile-m5-n320-train"
SEED = 2**31 + 27
LR = 0.05
SHAPE = {"batch": 2, "length": 24}
READING_BOUNDS = {"loss_rel": 1e-3, "grad_norm_gap": 1e-2, "grad_median_gap": 1e-6, "update_norm_gap": 5e-5}
A_RTOL, A_FLOOR, LL_RTOL = 1e-4, 1e-30, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU ops: the test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    """The benchmark's configuration at the tiny shape, lengths kept."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "learnmsa-profile-m5-n320.json").read_text())
    cfg["shape"] = dict(SHAPE)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The seeded weights, the port's layer on them and one batch."""
    cfg = _cfg()
    params = fam.make_params(cfg, SEED, "cpu")
    layer = fam.build_program(cfg, params, "cpu")
    x = fam.make_train_pool(cfg, {"pool": 1}, params, SEED, "cpu")[0]
    return cfg, params, layer, x


def _reference_model(params, i, n, x):
    """Model i of the reference in float64: (init, A, E, explicit
    probabilities, flank, emission matrix)."""
    p = {k: v.double() for k, v in params.items()}
    kernels = {name: p[f"transitions.kernels.{i}.{name}"] for name, _ in ref.explicit_parts(n) if name not in ref.SHARED}
    init, A, probs, flank = ref.implicit_model(kernels, p[f"transitions.flank_init_kernel.{i}"], n)
    B = ref.emission_matrix(p[f"emissions.0.emission_kernel.{i}"], p[f"emissions.0.insertion_kernel.{i}"])
    return init, A, x[i].double() @ B.T, probs, flank, B


def _assert_within(got, want, rtol, floor):
    gap = (got.double() - want).abs() / want.abs().clamp_min(floor)
    assert float(gap.max()) <= rtol, float(gap.max())


def _first_steps(cfg, seed, device, steps=3):
    """The program's first ``steps`` Adam steps through ``Trainer.fit``, as
    the benchmark's training driver records them."""
    params = fam.make_params(cfg, seed, device)
    pool = fam.make_train_pool(cfg, {"pool": steps}, params, seed, device)
    layer = fam.build_program(cfg, params, device)
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=LR), loss_fn=fam.program_loss(layer))
    names = {id(p): n for n, p in layer.named_parameters()}
    losses = []
    for j in range(steps):
        losses.append(float(trainer.fit([pool[j]])))
        if j == 0:
            grad1 = {names[id(p)]: (s["exp_avg"] / 0.1).double().cpu() for p, s in trainer.optimizer.state.items()}
    change = {n: (p.detach().double() - params[n].double()).cpu()
              for n, p in layer.named_parameters() if p.requires_grad}
    return params, pool, {"losses": losses, "grad1": grad1, "change": change}


def _readings(cfg, seed, device):
    params, pool, prog = _first_steps(cfg, seed, device)
    reference = checks.adam_follow(fam.reference_loss(cfg), params, pool, sorted(prog["change"]), LR, F64)
    return checks.training_readings(prog, reference)[0]


def test_lengths_are_the_align_rule_at_400_residues():
    """The configuration's lengths are what ``align`` gives five models of
    400-residue sequences: 0.8 x the median, two either side."""
    lengths = _cfg()["model"]["lengths"]
    assert cli._model_lengths([400] * 9, 5, None) == lengths == [318, 319, 320, 321, 322]
    assert [2 * n + 3 for n in lengths] == [639, 641, 643, 645, 647]


@pytest.mark.parametrize("i", range(5))
def test_elimination_matches_the_reference(setup, i):
    cfg, params, layer, x = setup
    n = cfg["model"]["lengths"][i]
    q, Q = 2 * n + 3, 2 * max(cfg["model"]["lengths"]) + 3
    with torch.no_grad():
        init, A = layer.transitions.matrices()
    assert tuple(A.shape) == (5, Q, Q) and tuple(init.shape) == (5, Q)
    init_r, A_r, *_ = _reference_model(params, i, n, x)
    _assert_within(A[i, :q, :q], A_r, A_RTOL, A_FLOOR)
    _assert_within(init[i, :q], init_r, A_RTOL, A_FLOOR)
    assert not A[i, q:].any() and not A[i, :, q:].any() and not init[i, q:].any()  # padded states: dead
    assert float((A[i, :q, :q].sum(-1) - 1).abs().max()) < 1e-5


def test_map_loss_parts_match_the_reference(setup):
    cfg, params, layer, x = setup
    with torch.no_grad():
        ll, prior, loss = layer.log_likelihood(x), layer.compute_prior(), layer.loss(x)
    prior_tol = 3 * (ref.ALPHA_SINGLE - 1) * 2.0**-24 / cfg["model"]["num_seqs"]
    for i, n in enumerate(cfg["model"]["lengths"]):
        init_r, A_r, E_r, probs, flank, B = _reference_model(params, i, n, x)
        _assert_within(ll[i], hmm.log_likelihood(init_r, A_r, E_r), LL_RTOL, 1.0)
        prior_r = (ref.transition_prior(probs, flank) + ref.amino_prior(B, n)) / cfg["model"]["num_seqs"]
        assert abs(float(prior[i]) - float(prior_r)) <= prior_tol, (i, float(prior[i]), float(prior_r))
    loss_r = fam.reference_loss(cfg)({k: v.double() for k, v in params.items()}, x)
    assert abs(float(loss) - float(loss_r)) <= LL_RTOL * float(ll.abs().max()) + prior_tol


def test_map_loss_and_gradients_in_float64_equal_the_reference(setup, monkeypatch):
    """The port's elimination, emissions, priors and sequential
    log-likelihood at n = 318-322, computed in float64 (the layer's entry
    casts its inputs to float32, so its parts are called), against the
    reference: the same mathematics, so agreement to float64's rounding.
    The port holds the Dirichlet mixtures' constants in float32 (as the JAX
    package does) and takes their normalisers in float32 whatever the
    probabilities' type, which at n = 320 moves the prior by ~1.5e-3
    nats: here both sides use the float32 constants in float64."""
    mixture = ref._mixture
    monkeypatch.setattr(ref, "_mixture", lambda name: [np.float32(v).astype(np.float64) for v in mixture(name)])
    monkeypatch.setattr(priors.FixedDirichlet, "log_pdf", lambda self, p: dirichlet_log_pdf(
        p, torch.as_tensor(self.alpha, dtype=p.dtype), torch.as_tensor(self.mix, dtype=p.dtype)))
    cfg, params, _, x = setup
    layer = fam.build_program(cfg, params, "cpu").double()
    own = dict(layer.named_parameters())
    names = [n for n, p in own.items() if p.requires_grad]
    init, A = layer.transitions.matrices()
    E = layer.emissions[0].emissions(x.double())
    loss = -(recursion.log_likelihood(init, A, E, 1).mean() + layer.compute_prior().mean())
    grads = torch.autograd.grad(loss, [own[n] for n in names])
    p64 = {k: v.double().requires_grad_() for k, v in params.items()}
    loss_r = fam.reference_loss(cfg)(p64, x)
    grads_r = torch.autograd.grad(loss_r, [p64[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-9)
    for n, g, r in zip(names, grads, grads_r):
        assert float((g - r).norm()) <= 1e-7 * max(float(r.norm()), 1.0), n


@pytest.mark.parametrize("seed", [SEED, 2**33 + 1])
def test_first_trainer_steps_agree_with_the_reference(seed):
    readings = _readings(_cfg(), seed, "cpu")
    for name, bound in READING_BOUNDS.items():
        assert readings[name] <= bound, (name, readings)


def _one_step_spans(layer, x):
    """The span names of one MAP loss and its backward under the profiler."""
    pars = [p for p in layer.parameters() if p.requires_grad]
    with profiling.span("hmm.test"):  # opened with the profiler off: ends the older session
        pass
    with torch.profiler.profile():
        grads = torch.autograd.grad(layer.loss(x), pars)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    return [r.name for r in profiling.recorded_spans()]


def test_a_map_step_opens_two_alphas_and_one_betas_span(setup):
    _, _, layer, x = setup
    cuda_forward.reset_launches()
    names = _one_step_spans(layer, x)
    assert names.count("hmm.recursion.loglik.alphas") == 2 and names.count("hmm.recursion.loglik.betas") == 1
    assert names.count("hmm.recursion.loglik") == 1 and names.count("hmm.recursion.loglik_vjp") == 1
    assert not any(cuda_forward.LAUNCHES.values())


def test_the_cell_runs_tiny_on_the_cpu():
    """One run of the cell through the benchmark's entry point, the
    lengths kept and the shape cut: ``correct`` and the end-to-end metrics.
    In a process of its own: the benchmark refuses to run beside JAX,
    which this suite loads."""
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3", "--trace", "0"]
    overrides = {"config": {"shape": SHAPE}, "traffic": {"pool": 4}}
    code = ("import sys, torch; torch.set_num_threads(1); from portbench import run; "
            f"sys.exit(run.main({argv!r}, device='cpu', overrides={overrides!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print("correct:", result["correct"], result["checks"])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"train_positions_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) for m in result["metrics"].values())


@pytest.mark.gpu
def test_q647_map_step_takes_k2c_k3c_on_the_card():
    """On the card, inside K2c/K3c's q <= 704: one MAP step launches K2c
    twice and K3c once and opens ``.alphas`` twice and ``.betas`` once; the first
    ``Trainer.fit`` steps agree with the reference within the CPU bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg()
    params = fam.make_params(cfg, SEED, "cuda")
    layer = fam.build_program(cfg, params, "cuda")
    x = fam.make_train_pool(cfg, {"pool": 1}, params, SEED, "cuda")[0]
    cuda_forward.reset_launches()
    names = _one_step_spans(layer, x)
    torch.cuda.synchronize()
    assert names.count("hmm.recursion.loglik.alphas") == 2 and names.count("hmm.recursion.loglik.betas") == 1
    assert cuda_forward.LAUNCHES == {"sum_chunk_summaries": 0, "sum_fwd_outputs": 0, "beta_bwd_outputs": 0,
                                     "sum_forward_wide": 2, "sum_backward_wide": 1}, cuda_forward.LAUNCHES
    readings = _readings(cfg, SEED, "cuda")
    for name, bound in READING_BOUNDS.items():
        assert readings[name] <= bound, (name, readings)
