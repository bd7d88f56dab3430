"""The port's training path against the JAX package on the same params and
inputs: ``HMMLayer.loss`` and ``posterior_cross_entropy`` (values and
gradients), the prior, sequence weights and config round trip, the
``Trainer`` (SGD steps against ``optax.sgd``, Adam lowering the loss,
micro-batches, checkpoints with optimizer state, model selection), the
utilities it uses, and ``python -m hmm_layer_torch train`` / ``evaluate``
end to end on the CPU."""

import functools
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hmm_layer_tpu import cli as jax_cli
from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models import GenePredEmissions as JaxEmissions
from hmm_layer_tpu.models import GenePredTransitions as JaxTransitions
from hmm_layer_tpu.training import Trainer as JaxTrainer
from hmm_layer_torch import HMMLayer, cli, load_jax_params, params_from_jax
from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions, annotation
from hmm_layer_torch.training import (
    Trainer,
    make_frozen_mask,
    microbatched_value_and_grad,
    select_models,
)
from hmm_layer_torch.utils import checkpoint
from hmm_layer_torch.utils.metrics import MetricsLogger, Throughput
from hmm_layer_torch.utils.resilience import HangWatchdog, latest_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def _inputs(seed, m=1, b=2, L=48):
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(m, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(m, b, L))]
    labels = rng.integers(0, 15, size=(m, b, L))
    mask = (rng.uniform(size=(m, b, L)) > 0.3).astype(np.float32)
    return np.concatenate([cls, nuc], axis=-1), labels, mask


def _layers(pf=4, num_models=1, **layer_kwargs):
    """The JAX gene-pred layer with random params around its init, and the
    port's layer holding the same params."""
    jl = JaxHMMLayer(JaxTransitions(num_models=num_models),
                     JaxEmissions(num_models=num_models, **CODONS),
                     parallel_factor=pf, **layer_kwargs)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.5, size=np.shape(x)).astype(np.float32),
        jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15)),
    )
    tl = HMMLayer(GenePredTransitions(num_models=num_models),
                  GenePredEmissions(num_models=num_models, **CODONS),
                  parallel_factor=pf, device="cpu", **layer_kwargs)
    load_jax_params(tl, params)
    return jl, params, tl


def _check_value_and_grads(jax_fn, params, port_value, tl, rtol=1e-4, atol=1e-5):
    value, grads = jax.value_and_grad(jax_fn)(params)
    np.testing.assert_allclose(float(port_value.detach()), float(value), rtol=rtol)
    ref = params_from_jax(jax.device_get(grads))
    pars = dict(tl.named_parameters())
    got = torch.autograd.grad(port_value, list(pars.values()))
    for name, g in zip(pars, got):
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=rtol, atol=atol * max(scale, 1.0))


@pytest.mark.parametrize("pf", [1, 4])
def test_loss_matches_jax(pf):
    jl, params, tl = _layers(pf, num_seqs=100)
    X, _, _ = _inputs(0)
    _check_value_and_grads(lambda p: jl.loss(p, jnp.asarray(X)), params, tl.loss(X), tl)


def test_loss_with_sequence_weights_matches_jax():
    weights = np.linspace(0.5, 2.0, 6).astype(np.float32)
    jl, params, tl = _layers(4, sequence_weights=weights)
    X, _, _ = _inputs(1)
    idx = np.array([[4, 1]])
    _check_value_and_grads(
        lambda p: jl.loss(p, jnp.asarray(X), indices=jnp.asarray(idx)), params,
        tl.loss(X, indices=idx), tl,
    )
    assert tl.get_config()["sequence_weights"] == jl.get_config()["sequence_weights"]
    with pytest.raises(ValueError, match="indices"):
        tl.loss(X)


CE_CASES = [
    pytest.param(1, False, False, id="labels-bL"),
    pytest.param(1, True, False, id="labels-bL-mask"),
    pytest.param(2, True, True, id="labels-mbL-mask-m2"),
    pytest.param(2, False, True, id="labels-mbL-m2"),
]


@pytest.mark.parametrize("m,use_mask,model_labels", CE_CASES)
def test_posterior_cross_entropy_matches_jax(m, use_mask, model_labels):
    jl, params, tl = _layers(4, num_models=m, num_seqs=50)
    X, labels, mask = _inputs(2, m=1)
    X = np.broadcast_to(X, (m,) + X.shape[1:]).copy()
    labels = np.broadcast_to(labels, (m,) + labels.shape[1:]).copy() if model_labels else labels[0]
    mask = np.broadcast_to(mask[0], labels.shape).copy() if use_mask else None
    j_mask = None if mask is None else jnp.asarray(mask)
    _check_value_and_grads(
        lambda p: jl.posterior_cross_entropy(p, jnp.asarray(X), jnp.asarray(labels), label_mask=j_mask),
        params, tl.posterior_cross_entropy(X, labels, label_mask=mask), tl,
    )


def test_call_prior_and_aux_match_jax():
    jl, params, tl = _layers(4, num_seqs=10)
    X, _, _ = _inputs(3)
    ll_j, mean_j, prior_j, aux_j = jl(params, jnp.asarray(X))
    with torch.no_grad():
        ll_t, mean_t, prior_t, aux_t = tl(X)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=2e-4)
    np.testing.assert_array_equal(prior_t.numpy(), np.asarray(prior_j))
    assert float(aux_t) == float(aux_j) == 0.0
    assert tuple(prior_t.shape) == (1,)


def test_from_config_round_trip():
    _, _, tl = _layers(4, num_seqs=7, sequence_weights=[1.0, 2.0, 3.0])
    config = tl.get_config()
    again = HMMLayer.from_config(json.loads(json.dumps(config, default=lambda o: np.asarray(o).tolist())),
                                 device="cpu")
    assert again.get_config() == json.loads(json.dumps(config, default=lambda o: np.asarray(o).tolist()))
    with pytest.raises(ValueError, match="unknown component class"):
        HMMLayer.from_config({**config, "transitions": {"class": "Nope", "config": {}}}, device="cpu")


def test_save_and_load_config(tmp_path):
    _, _, tl = _layers(4)
    path = str(tmp_path / "layer.json")
    checkpoint.save_config(path, tl.get_config())
    assert HMMLayer.from_config(checkpoint.load_config(path), device="cpu").get_config()["parallel_factor"] == 4


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _ce_batches(seed, steps):
    X, labels, mask = _inputs(seed, b=4)
    return [{"x": X, "labels": labels, "mask": mask}] * steps


def test_trainer_sgd_matches_optax_sgd():
    """Two SGD steps of the posterior CE: the same parameters as optax.sgd
    through the JAX trainer."""
    jl, params, tl = _layers(4)
    batches = _ce_batches(4, 2)

    jt = JaxTrainer(jl, optimizer=optax.sgd(0.5), loss_fn=lambda p, batch, idx: jl.posterior_cross_entropy(
        p, jnp.asarray(batch["x"]), jnp.asarray(batch["labels"]), label_mask=jnp.asarray(batch["mask"])))
    j_params, _, _ = jt.fit(params, jt.init_from_params(params), batches)

    tt = Trainer(tl, optimizer=functools.partial(torch.optim.SGD, lr=0.5),
                 loss_fn=lambda batch, idx: tl.posterior_cross_entropy(
                     batch["x"], batch["labels"], label_mask=batch["mask"]))
    tt.init_from_params()
    tt.fit(batches)
    ref = params_from_jax(jax.device_get(j_params))
    for name, p in tl.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-6)


def test_trainer_adam_lowers_the_loss():
    _, _, tl = _layers(4)
    batch = _ce_batches(5, 1)[0]
    first = float(tl.posterior_cross_entropy(batch["x"], batch["labels"], label_mask=batch["mask"]))
    trainer = Trainer(tl, optimizer=functools.partial(torch.optim.Adam, lr=0.05),
                      loss_fn=lambda b, idx: tl.posterior_cross_entropy(b["x"], b["labels"], label_mask=b["mask"]))
    trainer.init_from_params()
    trainer.fit([batch] * 15)
    last = float(tl.posterior_cross_entropy(batch["x"], batch["labels"], label_mask=batch["mask"]))
    assert last < first, (first, last)
    assert len(trainer.metrics.history) == 2  # steps 0 and 10


def test_trainer_map_default_loss_and_frozen_parameters():
    tl = HMMLayer(GenePredTransitions(transitions_trainable=False), GenePredEmissions(**CODONS),
                  parallel_factor=4, device="cpu")
    frozen = tl.transitions.transition_kernel.detach().clone()
    assert make_frozen_mask(tl) == {
        "transitions.transition_kernel": False,
        "transitions.starting_distribution_kernel": True,
        "emissions.0.emission_kernel": True,
    }
    trainer = Trainer(tl)
    optimizer = trainer.init(seed=3, input_dim=15)
    assert isinstance(optimizer, torch.optim.Adam) and optimizer.defaults["lr"] == 1e-2
    assert len(optimizer.param_groups[0]["params"]) == 2
    kernel = tl.emissions[0].emission_kernel.detach().clone()
    X, _, _ = _inputs(6)
    loss = trainer.fit([X, X], log_every=1)
    assert torch.isfinite(loss)
    assert torch.equal(tl.transitions.transition_kernel, frozen)
    assert not torch.equal(tl.emissions[0].emission_kernel, kernel)


def test_microbatched_value_and_grad_equals_whole_batch():
    _, _, tl = _layers(4)
    X, labels, _ = _inputs(7, b=4)
    params = list(tl.parameters())
    batch = {"x": X, "labels": labels}

    def loss_fn(part):
        return tl.posterior_cross_entropy(part["x"], part["labels"])

    loss, grads = microbatched_value_and_grad(loss_fn, params, batch, 2)
    full = loss_fn(batch)
    full_grads = torch.autograd.grad(full, params)
    np.testing.assert_allclose(float(loss), float(full), rtol=1e-5)
    for g, r in zip(grads, full_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        microbatched_value_and_grad(loss_fn, params, batch, 3)


def test_microbatched_trainer_refuses_indices():
    _, _, tl = _layers(4, sequence_weights=[1.0, 1.0])
    trainer = Trainer(tl, microbatch=1)
    X, _, _ = _inputs(8)
    with pytest.raises(ValueError, match="microbatch"):
        trainer.fit([(X, np.array([[0, 1]]))])


def test_checkpoint_with_optimizer_state_round_trips(tmp_path):
    _, _, tl = _layers(4)
    trainer = Trainer(tl, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    X, _, _ = _inputs(9)
    trainer.init_from_params()
    trainer.fit([X] * 3)
    path, step = latest_checkpoint(str(tmp_path))
    assert step == 2 and checkpoint.load_metadata(path)["step"] == 2

    _, _, other = _layers(4)
    fresh = Trainer(other)
    optimizer = fresh.restore(path)
    saved = np.load(path)
    for name, p in other.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), saved["params/" + name.replace(".", "/")])
    state = optimizer.state_dict()["state"]
    assert len(state) == 3 and float(state[0]["step"]) == 3.0
    np.testing.assert_array_equal(state[2]["exp_avg"].numpy(), saved["opt_state/state/2/exp_avg"])
    # A params-only checkpoint still loads, and keeps the optimizer as it is.
    params_only = str(tmp_path / "params.npz")
    checkpoint.save_checkpoint(params_only, tl)
    before = {k: v.clone() for k, v in fresh.optimizer.state_dict()["state"][0].items()}
    fresh.restore(params_only)
    for name, p in other.state_dict().items():
        torch.testing.assert_close(p, tl.state_dict()[name], rtol=0, atol=0)
    for k, v in fresh.optimizer.state_dict()["state"][0].items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    # ...and so does the training checkpoint into a bare layer.
    checkpoint.load_checkpoint(path, other)


def test_restored_optimizer_continues_like_the_original(tmp_path):
    _, _, tl = _layers(4)
    X, _, _ = _inputs(10)
    trainer = Trainer(tl)
    trainer.init_from_params()
    trainer.fit([X] * 2)
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, tl, step=2, optimizer=trainer.optimizer)
    _, _, other = _layers(4)
    resumed = Trainer(other)
    resumed.restore(path)
    trainer.fit([X])
    resumed.fit([X])
    for name, p in tl.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], p, rtol=0, atol=0)


def test_mesh_is_not_ported():
    """``Trainer(mesh=...)`` is ported now: a mesh without the data axis
    raises as the JAX layer's partition check does, and on a one-rank mesh
    (no process group) the data-parallel route takes the same SGD steps as
    the single-device trainer."""
    from hmm_layer_torch.parallel import make_mesh

    _, _, tl = _layers(4)
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        Trainer(tl, mesh=make_mesh({"seq": 1}))
    X, _, _ = _inputs(12)
    _, _, plain = _layers(4)
    _, _, sharded = _layers(4)
    sgd = functools.partial(torch.optim.SGD, lr=0.05)
    Trainer(plain, optimizer=sgd).fit([X] * 2)
    trainer = Trainer(sharded, optimizer=sgd, mesh=make_mesh({"data": 1}))
    assert sharded.partition == {"batch": "data"}
    trainer.fit([X] * 2)
    for name, p in plain.state_dict().items():
        torch.testing.assert_close(sharded.state_dict()[name], p, rtol=1e-6, atol=1e-6)


def test_fit_select_keeps_the_best_model():
    jl, params, tl = _layers(4, num_models=3)
    X, _, _ = _inputs(11, m=3)
    trainer = Trainer(tl, optimizer=functools.partial(torch.optim.SGD, lr=0.0))
    result = trainer.fit_select([X], [X], keep=1)
    assert result.layer.transitions.num_models == 1
    best = int(result.ranking[0])
    with torch.no_grad():
        ll_joint = tl.log_likelihood(X)[best]
        ll_sel = result.layer.log_likelihood(X[best : best + 1])[0]
    torch.testing.assert_close(ll_sel, ll_joint, rtol=0, atol=0)
    with torch.no_grad():
        np.testing.assert_allclose(result.scores, tl.log_likelihood(X).mean(1).numpy(), rtol=1e-6)
    copy = select_models(tl.emissions[0], [2, 0])
    torch.testing.assert_close(copy.emission_kernel, tl.emissions[0].emission_kernel.detach()[[2, 0]])


def test_reset_parameters_equals_the_jax_init():
    jl = JaxHMMLayer(JaxTransitions(), JaxEmissions(**CODONS))
    ref = params_from_jax(jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15)))
    _, _, tl = _layers(4)
    tl.reset_parameters(input_dim=15)
    for name, p in tl.state_dict().items():
        torch.testing.assert_close(p, ref[name], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


def test_metrics_logger_and_throughput(tmp_path):
    path = tmp_path / "metrics.jsonl"
    stream = io.StringIO()
    logger = MetricsLogger(str(path), stream=stream)
    logger.log(0, loss=torch.tensor(1.5), note="x")
    logger.close()
    assert json.loads(path.read_text()) == {"step": 0, "loss": 1.5, "note": "x"}
    assert "1.5" in stream.getvalue()
    meter = Throughput()
    meter.update(4)
    assert meter.seqs_per_sec > 0


def test_hang_watchdog_fires_and_disarms():
    stream = io.StringIO()
    fired = []
    with HangWatchdog(0.05, on_timeout=lambda: fired.append(1), stream=stream) as wd:
        import time

        time.sleep(0.3)
    assert wd.fired and fired == [1] and "exceeded" in stream.getvalue()
    with HangWatchdog(5.0, stream=io.StringIO()) as quiet:
        pass
    assert not quiet.fired


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def _gene_track(length):
    """A grammar-valid state track: intergenic, one spliced gene, intergenic."""
    Ir, I1, E0, E1, E2, ST, EI1, IE1, SP = 0, 2, 4, 5, 6, 7, 9, 12, 14
    gene = [ST] + [E1, E2, E0] * 30 + [E1, EI1] + [I1] * 50 + [IE1, E1] + [E2, E0, E1] * 20 + [SP]
    return np.array([Ir] * 100 + gene + [Ir] * (length - 100 - len(gene)))


def _tiny_annotated_genome(tmp_path):
    """Two contigs of seeded DNA and a reference GFF3 with one gene on the
    plus strand of the first and one on the minus strand of the second."""
    rng = np.random.default_rng(12)
    fasta = tmp_path / "g.fa"
    lengths = {"c1": 700, "c2": 500}
    with open(fasta, "w") as fh:
        for name, n in lengths.items():
            fh.write(f">{name}\n" + "".join("ACGT"[i] for i in rng.integers(0, 4, size=n)) + "\n")
    genes = {
        "c1": annotation.paths_to_genes(_gene_track(700), num_states=15),
        "c2": annotation.flip_genes(annotation.paths_to_genes(_gene_track(500), num_states=15), 500),
    }
    assert [len(g) for g in genes.values()] == [1, 1]
    gff = tmp_path / "ref.gff3"
    annotation.write_gff3(genes, str(gff))
    return fasta, gff


@pytest.mark.parametrize("objective", ["ce", "map"])
def test_train_cli_writes_a_checkpoint_predict_loads(tmp_path, objective, capsys):
    fasta, gff = _tiny_annotated_genome(tmp_path)
    out = tmp_path / f"trained_{objective}.npz"
    argv = ["train", "-i", str(fasta), "-o", str(out), "--objective", objective,
            "--steps", "3", "--window", "128", "--batch", "2", "--parallel-factor", "4",
            "--both-strands", "--cpu"]
    if objective == "ce":
        argv += ["-a", str(gff)]
    assert cli.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
    assert checkpoint.load_metadata(str(out))["step"] == 3
    pred = tmp_path / "pred.gff3"
    assert cli.main(["predict", "-i", str(fasta), "-o", str(pred), "--params", str(out),
                     "--window", "128", "--batch", "2", "--parallel-factor", "4", "--cpu"]) == 0
    # The JAX package reads the port's trained checkpoint too.
    assert jax_cli.main(["predict", "-i", str(fasta), "-o", str(tmp_path / "jpred.gff3"),
                         "--params", str(out), "--window", "128", "--batch", "2",
                         "--parallel-factor", "4", "--cpu"]) == 0


def test_train_cli_ce_needs_annotation(tmp_path, capsys):
    fasta, _ = _tiny_annotated_genome(tmp_path)
    assert cli.main(["train", "-i", str(fasta), "-o", str(tmp_path / "x.npz"), "--cpu"]) == 2
    assert "requires -a" in capsys.readouterr().err


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    _, gff = _tiny_annotated_genome(tmp_path)
    assert cli.main(["evaluate", "--pred", str(gff), "--truth", str(gff)]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["evaluate", "--pred", str(gff), "--truth", str(gff)]) == 0
    assert ours == json.loads(capsys.readouterr().out)
