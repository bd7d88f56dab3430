"""The port's ``align`` command (``python -m hmm_layer_torch align``) on the
CPU, the counterparts of ``tests/test_cli.py::TestAlign``, and a
planted-truth alignment at the size of
``tests/test_quality.py::TestMsaQuality``: sequences sampled from a
planted profile HMM (the JAX test's generator), fresh port models trained
with ``Trainer.fit_select``, every sequence decoded and scored against the
true alignment."""

import functools

import numpy as np
import pytest
import torch

from hmm_layer_tpu.cli import _model_lengths as j_model_lengths
from hmm_layer_torch import HMMLayer, Trainer, data
from hmm_layer_torch import models as tm
from hmm_layer_torch.cli import _model_lengths, build_parser, main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_family(path, seed, insert_tail):
    rng = np.random.default_rng(seed)
    consensus = "MKLVAEQWRD"
    names = []
    with open(path, "w") as fh:
        for i in range(8):
            seq = "".join(c for c in consensus if rng.random() > 0.1)  # deletions
            if insert_tail and rng.random() < 0.5:
                seq += "AG"  # C-terminal insertions
            names.append(f"seq{i}")
            fh.write(f">seq{i} desc\n{seq}\n")
    return names


def _check_alignment(fasta, out, names=None):
    aln = list(data.read_fasta(out))
    if names is not None:
        assert [n for n, _ in aln] == names
    # Aligned FASTA: equal-length rows whose residues (minus gaps)
    # reproduce the input sequences.
    assert len({len(r) for _, r in aln}) == 1
    orig = dict(data.read_fasta(fasta))
    for n, row in aln:
        assert row.replace("-", "").replace(".", "").upper() == orig[n]
    return aln


class TestAlignCommand:
    def test_args_and_defaults(self):
        args = build_parser().parse_args(["align", "-i", "a.fa", "-o", "b.fa"])
        assert (args.models, args.steps, args.batch, args.lr) == (3, 100, 32, 0.05)
        assert args.precision == "high" and args.adapt_rounds == 0 and not args.cpu
        assert args.model_length is None and args.expand_threshold is None and args.seed == 0

    @pytest.mark.parametrize("lens,n,override", [([10, 8, 9], 3, None), ([40, 50, 60, 70], 2, None), ([5], 4, 12), ([1, 2], 1, None)])
    def test_model_lengths_equal_jax(self, lens, n, override):
        assert _model_lengths(lens, n, override) == j_model_lengths(lens, n, override)

    def test_align_end_to_end(self, tmp_path):
        fasta, out = tmp_path / "prot.fa", tmp_path / "aln.fa"
        names = _write_family(fasta, 0, insert_tail=True)
        rc = main(["align", "-i", str(fasta), "-o", str(out), "--models", "2", "--steps", "6",
                   "--batch", "8", "--cpu"])
        assert rc == 0
        _check_alignment(fasta, out, names)

    def test_align_with_adaptation(self, tmp_path, capsys):
        """--adapt-rounds: learnMSA-style length adaptation mid-training."""
        fasta, out = tmp_path / "prot.fa", tmp_path / "aln.fa"
        _write_family(fasta, 3, insert_tail=False)
        rc = main(["align", "-i", str(fasta), "-o", str(out), "--models", "1", "--steps", "8",
                   "--adapt-rounds", "1", "--batch", "8", "--cpu"])
        assert rc == 0
        assert "adaptation round 1: lengths" in capsys.readouterr().out
        _check_alignment(fasta, out)

    @pytest.mark.parametrize("found", ["highest", "high"])
    def test_align_restores_the_dp_precision_it_found(self, tmp_path, found):
        """``main`` runs in-process (tests, examples): ``align`` sets
        ``--precision`` (default ``high``) for its own run only, and leaves
        ``set_dp_precision``'s mode as it found it."""
        from hmm_layer_torch.ops import recursion

        fasta, out = tmp_path / "prot.fa", tmp_path / "aln.fa"
        _write_family(fasta, 1, insert_tail=False)
        flags = {"highest": [], "high": ["--precision", "highest"]}[found]
        with recursion.dp_precision(found):
            rc = main(["align", "-i", str(fasta), "-o", str(out), "--models", "1", "--steps", "2",
                       "--batch", "8", "--cpu", *flags])
            assert rc == 0
            assert recursion._dp_mode == found

    def test_align_empty_input(self, tmp_path):
        fasta = tmp_path / "empty.fa"
        fasta.write_text("")
        assert main(["align", "-i", str(fasta), "-o", str(tmp_path / "o"), "--cpu"]) == 2


class TestPlantedAlignment:
    def test_trained_profile_recovers_planted_alignment(self):
        """The JAX test's planted family (Lm = 8, 32 sequences) and
        thresholds: two candidate lengths trained 150 Adam(0.1) steps
        with fit_select, pairs F1 >= 0.9, column score >= 0.6."""
        from test_quality import make_planted_profile, sample_planted_msa

        rng = np.random.default_rng(0)
        Lm, S = 8, 25
        trans, emit = make_planted_profile(rng, Lm=Lm, S=S)
        x_full, res, lens, true_rows = sample_planted_msa(rng, trans, emit)
        b = x_full.shape[0]
        cand = [Lm - 1, Lm]
        layer = HMMLayer(
            tm.ProfileTransitions(cand, generator=torch.Generator().manual_seed(3)),
            tm.ProfileEmissions(cand, input_dim=S + 1),
            use_prior=True,
            num_seqs=b,
            device="cpu",
        )
        trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=0.1))
        xb = torch.from_numpy(np.ascontiguousarray(x_full))[None].expand(2, *x_full.shape)
        result = trainer.fit_select((xb for _ in range(150)), (xb for _ in range(1)), keep=1)
        best = int(result.ranking[0])
        paths = result.layer.viterbi(torch.from_numpy(x_full)[None])[0].numpy()
        pred_rows = tm.paths_to_msa(paths, res, model_length=cand[best], seq_lengths=lens)
        mets = tm.evaluate_msa(pred_rows, true_rows)
        assert mets["pairs"]["f1"] >= 0.9, mets["pairs"]
        assert mets["column_score"] >= 0.6, mets
