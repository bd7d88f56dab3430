"""The port's examples (``examples/torch_*.py``) run under ``--cpu`` at
their smallest flags and print what shows they ran through, as
``tests/test_example.py`` does for the JAX ones; the mesh examples run a
world of two ranks under gloo."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def test_gene_prediction_example(tmp_path, capsys):
    rng = np.random.default_rng(1)
    fa = tmp_path / "c.fa"
    fa.write_text(f">ctg1\n{''.join(rng.choice(list('ACGT'), size=256))}\n")
    gp = _example("torch_gene_prediction")
    assert gp.main([str(fa), "--window", "64", "--batch", "2", "--parallel-factor", "4", "--cpu"]) == 0
    assert "ctg1: L=256" in capsys.readouterr().out
    runs = gp.intervals(np.asarray([0, 0, 4, 4, 4, 1, 0], np.int32))
    assert runs == [("Ir", 0, 2), ("E0", 2, 5), ("I0", 5, 6), ("Ir", 6, 7)]


def test_train_profile_msa_example(capsys):
    assert _example("torch_train_profile_msa").main(["--steps", "2", "--batch", "4", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "selected model" in out and out.rstrip().endswith("done.")


def test_distributed_training_example(capsys):
    """Two ranks ({"data": 1, "seq": 2}) train the simple family; the exit
    code says the loss fell on every rank."""
    dt = _example("torch_distributed_training")
    assert dt.main(["--steps", "2", "--batch", "4", "--length", "32", "--cpu"]) == 0
    assert "after 2 sharded steps" in capsys.readouterr().out


def test_train_sparse_multichip_example(capsys):
    """The data route, the layer's edge-sharded state route, and the
    functions under ``local=True``, whose loglik and paths equal the layer
    route's on every rank."""
    sm = _example("torch_train_sparse_multichip")
    assert sm.main(["--k", "2", "--length", "32", "--steps", "2", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("equal to the layer route's: True") == 2


def test_train_dirichlet_priors_example(tmp_path, capsys):
    """It writes under ``--out`` only, and what it wrote loads back."""
    from hmm_layer_torch.models import load_mixture_model

    dp = _example("torch_train_dirichlet_priors")
    assert dp.main(["--steps", "2", "--samples", "200", "--out", str(tmp_path), "--cpu"]) == 0
    assert "saved" in capsys.readouterr().out
    sizes = {"amino_prior_9": 20, "match_prior_1": 3, "insert_prior_1": 2, "delete_prior_1": 2}
    assert sorted(os.listdir(tmp_path)) == sorted(f"{name}.npz" for name in sizes)
    for name, k in dp.PRIORS:
        path = tmp_path / f"{name}.npz"
        model = load_mixture_model(str(path), k, sizes[name])
        with np.load(path) as saved:
            for key, value in model.state_dict().items():
                np.testing.assert_array_equal(value.numpy(), saved[key])
        assert model.make_alpha().shape == (k, sizes[name])
