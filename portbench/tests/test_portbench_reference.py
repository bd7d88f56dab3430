"""The plain reference against the port's three timed entries at tiny
sizes on the CPU: the posterior cross-entropy and the MAP loss with their
gradients, the parameters after Adam steps, and a decoded track's path
score. And the lower-precision control, which must read worse than the
program."""

import functools

import pytest
import torch

from portbench import checks
from portbench.models import genepred, profile
from portbench.reference import hmm
from portbench.reference import genepred as rgp
from portbench.reference.hmm import F64, TF32

GENE = {
    "model": {
        "codons": {"start_codons": [["ATG", 1.0]], "stop_codons": [["TAG", 0.34], ["TAA", 0.33], ["TGA", 0.33]],
                   "intron_begin_pattern": [["NGT", 0.99], ["NGC", 0.005], ["NAT", 0.005]],
                   "intron_end_pattern": [["AGN", 0.99], ["ACN", 0.01]]},
        "initial_exon_len": 100, "initial_intron_len": 10000, "initial_ir_len": 10000, "parallel_factor": 1},
    "weights": {"noise_sd": 0.5},
    "shape": {"batch": 2, "length": 300},
}
PROF = {
    "model": {"lengths": [6, 8], "input_dim": 26, "use_prior": True, "num_seqs": 1000, "parallel_factor": 1},
    "weights": {"noise_sd": 0.1},
    "shape": {"batch": 2, "length": 40},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program_first_steps(fam, cfg, traffic, seed, steps=3):
    """The program's first ``steps`` Adam steps through ``Trainer.fit``, as
    the training driver records them."""
    from hmm_layer_torch import Trainer

    params = fam.make_params(cfg, seed, "cpu")
    pool = fam.make_train_pool(cfg, {"pool": steps}, params, seed, "cpu")
    layer = fam.build_program(cfg, params, "cpu")
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=traffic["lr"]),
                      loss_fn=fam.program_loss(layer))
    names = {id(p): n for n, p in layer.named_parameters()}
    losses = []
    for j in range(steps):
        losses.append(float(trainer.fit([pool[j]])))
        if j == 0:
            grad1 = {names[id(p)]: (s["exp_avg"] / 0.1).double() for p, s in trainer.optimizer.state.items()}
    change = {n: p.detach().double() - params[n].double() for n, p in layer.named_parameters() if p.requires_grad}
    return params, pool, {"losses": losses, "grad1": grad1, "change": change}


@pytest.mark.parametrize("family,cfg,lr,bound", [
    (genepred, GENE, 0.01, 2e-3),
    (profile, PROF, 0.05, 5e-3),
], ids=["ce", "map"])
def test_first_steps_agree_with_the_reference(family, cfg, lr, bound):
    params, pool, prog = program_first_steps(family, cfg, {"lr": lr}, seed=2**31 + 11)
    ref = checks.adam_follow(family.reference_loss(cfg), params, pool, sorted(prog["change"]), lr, F64)
    readings, _ = checks.training_readings(prog, ref)
    assert max(readings.values()) < bound, readings


def test_ce_value_and_gradients():
    """The emissions in float32 against float64, then the port's posterior
    (sequential and chunked) in float64 on the reference's emissions."""
    from hmm_layer_torch.ops import recursion

    params = genepred.make_params(GENE, 3, "cpu")
    batch = genepred.make_train_pool(GENE, {"pool": 1}, params, 3, "cpu")[0]
    layer = genepred.build_program(GENE, params, "cpu")
    p64 = {k: v.double().requires_grad_() for k, v in params.items()}
    E64 = rgp.emissions(p64, batch["x"][0], genepred.codons(GENE), True)
    E32 = layer.emissions[0].emissions(batch["x"], training=True)[0]
    assert float(((E32.double() - E64).abs() / E64).max()) < 2e-6
    ref = genepred.reference_loss(GENE)(p64, batch)
    init, A = genepred.build_program(GENE, params, "cpu").double().transitions.matrices()
    labels = batch["labels"][0].long()
    for P in (1, 4):
        lg, _ = recursion.posterior(init, A, E64.detach()[None], P)
        ce = -lg[0].gather(-1, labels[..., None]).mean()
        assert float(ce) == pytest.approx(float(ref), rel=1e-12 if P == 1 else 1e-9)
    loss = genepred.program_loss(layer)(batch, None)
    grads = torch.autograd.grad(loss, list(layer.parameters()))
    ref_grads = torch.autograd.grad(ref, [p64[n] for n, _ in layer.named_parameters()])
    assert float(loss) == pytest.approx(float(ref), rel=5e-4)
    for g, r in zip(grads, ref_grads):
        assert float((g.double() - r).norm()) <= 1e-3 * float(r.norm())


def test_map_value_and_gradients_with_priors():
    """The port's transitions, emissions, priors and sequential
    log-likelihood in float64 against the reference's."""
    from hmm_layer_torch.ops import recursion

    params = profile.make_params(PROF, 4, "cpu")
    x = profile.make_train_pool(PROF, {"pool": 1}, params, 4, "cpu")[0].double()
    layer = profile.build_program(PROF, params, "cpu").double()
    init, A = layer.transitions.matrices()
    E = layer.emissions[0].emissions(x)
    loss = -(recursion.log_likelihood(init, A, E, 1).mean() + layer.compute_prior().mean())
    names = [n for n, p in layer.named_parameters() if p.requires_grad]
    own = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [own[n] for n in names])
    p64 = {k: v.double().requires_grad_() for k, v in params.items()}
    ref = profile.reference_loss(PROF)(p64, x)
    ref_grads = torch.autograd.grad(ref, [p64[n] for n in names])
    assert float(loss) == pytest.approx(float(ref), rel=1e-9)
    for n, g, r in zip(names, grads, ref_grads):
        assert float((g - r).norm()) <= 1e-7 * max(float(r.norm()), 1.0), n


def test_decoded_track_scores_the_best_path():
    cfg = dict(GENE, model=dict(GENE["model"], parallel_factor=4))
    params = genepred.make_params(cfg, 6, "cpu")
    x = genepred.class_inputs(torch.Generator().manual_seed(6), (1, 3, 400), "cpu")
    layer = genepred.build_program(cfg, params, "cpu")
    with torch.no_grad():
        path = layer.viterbi(x)[0].long()
    p64 = {k: v.double() for k, v in params.items()}
    init, A = rgp.matrices(p64)
    E = rgp.emissions(p64, x[0], genepred.codons(cfg), False)
    best = hmm.viterbi_score(init, A, E)
    assert torch.allclose(hmm.path_score(init, A, E, path), best, rtol=1e-9, atol=1e-6)
    pinned = torch.zeros(E.shape, dtype=torch.bool).scatter_(-1, path[..., None], True)
    assert torch.allclose(hmm.viterbi_score(init, A, E, pinned), best, rtol=1e-9, atol=1e-6)
    other = path.clone()
    other[:, 200] = (other[:, 200] + 1) % 15
    moved = torch.zeros(E.shape, dtype=torch.bool).scatter_(-1, other[..., None], True)
    assert (best - hmm.viterbi_score(init, A, E, moved) > 1e-3).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-12), 3.0])
    assert hmm.tf32_round(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -1.0, 3.0]


@pytest.mark.parametrize("family,cfg,lr", [(genepred, GENE, 0.01), (profile, PROF, 0.05)], ids=["ce", "map"])
def test_the_control_reads_worse_than_the_program(family, cfg, lr):
    """The reference in TF32 in the program's place: its first steps
    depart from the float64 reference by more than the program's."""
    params, pool, prog = program_first_steps(family, cfg, {"lr": lr}, seed=77)
    loss = family.reference_loss(cfg)
    trainable = sorted(prog["change"])
    ref = checks.adam_follow(loss, params, pool, trainable, lr, F64)
    ctl = checks.adam_follow(loss, params, pool, trainable, lr, TF32)
    program, _ = checks.training_readings(prog, ref)
    control, _ = checks.training_readings(ctl, ref)
    assert max(control[k] / max(program[k], 1e-12) for k in control) >= 3.0, (program, control)
