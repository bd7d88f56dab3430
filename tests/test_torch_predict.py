"""The port's host side of gene prediction against the JAX package on the
same inputs: FASTA reading and DNA encoding (``hmm_layer_torch.data``),
gene extraction and GFF3 (``models.annotation``), checkpoints in the shared
``.npz`` format (``utils.checkpoint``), and ``predict`` end to end through
both command lines."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from hmm_layer_tpu import cli as jax_cli
from hmm_layer_tpu import data as jdata
from hmm_layer_tpu.models import annotation as jann
from hmm_layer_tpu.utils import checkpoint as jckpt
from hmm_layer_torch import cli, data
from hmm_layer_torch.models import annotation
from hmm_layer_torch.models.initializers import make_15_class_emission_kernel
from hmm_layer_torch.utils import checkpoint
from oracle import stitched_track_np, window_inputs_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent


def _random_dna(rng, n, alphabet="ACGT"):
    return "".join(np.asarray(list(alphabet))[rng.integers(0, len(alphabet), size=n)])


def _write_fasta(path, records, width=60):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        for name, seq in records:
            fh.write(f">{name} some description\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("suffix", [".fa", ".fa.gz"])
def test_fasta_reading_and_encoding_match_jax(tmp_path, suffix):
    rng = np.random.default_rng(0)
    records = [("ctg1", _random_dna(rng, 250, "ACGTNRYacgtn")), ("ctg2", "AC GT\tW"),
               ("ctg3", _random_dna(rng, 61))]
    path = tmp_path / f"in{suffix}"
    _write_fasta(path, records)
    assert list(data.read_fasta(path)) == list(jdata.read_fasta(path))
    got = list(data.read_fasta_encoded(path))
    ref = list(jdata.read_fasta_encoded(path, "dna"))
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(data.revcomp_onehot(g), jdata.revcomp_onehot(r))
    seq = records[0][1]
    assert data.revcomp(seq) == jdata.revcomp(seq)
    np.testing.assert_array_equal(
        data.encode_dna(data.revcomp(seq)), data.revcomp_onehot(data.encode_dna(seq))
    )


@pytest.mark.parametrize("L,window,batch,overlap", [(2400, 600, 4, 64), (97, 32, 3, 8),
                                                    (10, 32, 2, 0), (0, 8, 2, 0)])
def test_window_batches_match_jax(L, window, batch, overlap):
    enc = data.encode_dna(_random_dna(np.random.default_rng(L), L))
    got = list(data.window_batches(enc, window, batch, overlap))
    ref = list(jdata.window_batches(enc, window, batch, overlap))
    assert len(got) == len(ref)
    for (gw, gs), (rw, rs) in zip(got, ref):
        np.testing.assert_array_equal(gw, rw)
        np.testing.assert_array_equal(gs, rs)
    with pytest.raises(ValueError, match="overlap"):
        list(data.window_batches(enc, 8, 2, 8))


# (L, window, batch, overlap, strand): a contig shorter than a window, one
# an exact multiple of the stride, and last batches with fill windows (with
# overlap 64, a fill window's rows reach into the contig's tail).
DECODE_WINDOW_CASES = [
    pytest.param(50, 64, 2, 8, "+", id="L-below-window"),
    pytest.param(336, 64, 3, 8, "+", id="L-multiple-of-stride"),
    pytest.param(400, 64, 4, 0, "+", id="fill-windows-overlap-0"),
    pytest.param(1000, 200, 3, 64, "+", id="fill-windows-overlap-64"),
    pytest.param(1000, 200, 3, 64, "-", id="reverse-strand"),
]


@pytest.mark.parametrize("L,window,batch,overlap,strand", DECODE_WINDOW_CASES)
def test_decode_contig_batches_equal_the_window_batches(L, window, batch, overlap, strand):
    rng = np.random.default_rng(L + overlap)
    enc = data.encode_dna(_random_dna(rng, L, "ACGTN"))
    enc = data.revcomp_onehot(enc) if strand == "-" else enc
    cls = rng.dirichlet(np.ones(15), L).astype(np.float32)
    got = []

    def viterbi_fn(x):
        got.append(x.clone())
        return torch.zeros(x.shape[:3], dtype=torch.int32)

    cli.decode_contig(viterbi_fn, enc, cls, window, batch, overlap)
    ref = [x for x, _ in window_inputs_np(enc, cls, window, batch, overlap)]
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.equal(g, torch.from_numpy(r))


@pytest.mark.parametrize("strand", ["+", "-"])
def test_decode_contig_track_equals_the_numpy_batches_track(strand):
    rng = np.random.default_rng(4)
    enc = data.encode_dna(_random_dna(rng, 1000))
    enc = data.revcomp_onehot(enc) if strand == "-" else enc
    cls = rng.dirichlet(np.ones(15) * 0.3, 1000).astype(np.float32)
    layer = cli._gene_pred_layer(4, "cpu")
    with torch.inference_mode():
        got = cli.decode_contig(layer.viterbi, enc, cls, 200, 3, 64)
        ref = stitched_track_np(layer.viterbi, enc, cls, 200, 3, 64)
    assert len(set(got.tolist())) > 1
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# annotation
# ---------------------------------------------------------------------------


def _grammar_walk(rng, L):
    """A state path of the 15-state grammar: a random walk on the default
    gene-pred A with its long-stay rows flattened, so genes start and end."""
    from hmm_layer_torch.models import GenePredTransitions

    A = GenePredTransitions().make_A().detach()[0].double().numpy()
    loops = np.diag(A) > 0
    moves = A * (1.0 - np.eye(15))
    moves /= moves.sum(-1, keepdims=True)
    A = np.diag(np.where(loops, 0.5, 0.0)) + np.where(loops, 0.5, 1.0)[:, None] * moves
    path = np.zeros(L, np.int64)
    for t in range(1, L):
        path[t] = rng.choice(15, p=A[path[t - 1]])
    return path


def _gene_key(g):
    return (g.start, g.end, tuple(g.cds), tuple(g.introns), g.copy, g.partial_5p,
            g.partial_3p, g.strand)


@pytest.mark.parametrize("seed", [0, 1])
def test_annotation_matches_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    path = _grammar_walk(rng, 1500)
    got = annotation.paths_to_genes(path, num_states=15, offset=7)
    ref = jann.paths_to_genes(path, num_states=15, offset=7)
    assert got and [_gene_key(g) for g in got] == [_gene_key(g) for g in ref]
    flipped = annotation.flip_genes(got, 2000)
    assert [_gene_key(g) for g in flipped] == [_gene_key(g) for g in jann.flip_genes(ref, 2000)]
    assert [ln.split("\t")[3:] for ln in annotation.genes_to_gff3(got, "c")] == \
        [ln.split("\t")[3:] for ln in jann.genes_to_gff3(ref, "c")]
    for kind in ("simple", "full"):
        num_states, simple = (7, True) if kind == "simple" else (15, False)
        np.testing.assert_array_equal(
            np.stack(annotation.classify_states(num_states, simple)),
            np.stack(jann.classify_states(num_states, simple)),
        )
    complete = [g for g in got if not g.partial_5p and not g.partial_3p]
    np.testing.assert_array_equal(
        annotation.genes_to_states(complete, 1510, offset=7),
        jann.genes_to_states(complete, 1510, offset=7),
    )

    out = tmp_path / "genes.gff3"
    n = annotation.write_gff3({"c": got, "d": flipped}, out)
    assert n == len(got) + len(flipped)
    back = annotation.read_gff3(out)
    ref_back = jann.read_gff3(out)
    for seqid in ("c", "d"):
        assert [_gene_key(g) for g in back[seqid]] == [_gene_key(g) for g in ref_back[seqid]]
    assert annotation.evaluate_annotation(back, {"c": got}) == \
        jann.evaluate_annotation(ref_back, {"c": ref})


# ---------------------------------------------------------------------------
# checkpoints and the class kernel
# ---------------------------------------------------------------------------


def _jax_params(seed=0):
    layer = jax_cli._gene_pred_layer(8)
    params = jax.device_get(layer.init_params(jax.random.PRNGKey(0), input_dim=15))
    rng = np.random.default_rng(seed)
    return layer, jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.3, size=np.shape(x)).astype(np.float32), params
    )


def test_class_kernel_matches_jax():
    from hmm_layer_tpu.models.initializers import make_15_class_emission_kernel as jmake

    for kw in ({}, {"smoothing": 0.2, "num_copies": 2, "num_models": 3}):
        np.testing.assert_array_equal(make_15_class_emission_kernel(**kw), jmake(**kw))
    with pytest.raises(ValueError, match="smoothing"):
        make_15_class_emission_kernel(smoothing=0.0)


def test_default_predict_layer_equals_jax_init():
    jl = jax_cli._gene_pred_layer(8)
    params = jax.device_get(jl.init_params(jax.random.PRNGKey(0), input_dim=15))
    tl = cli._gene_pred_layer(8, "cpu")
    from hmm_layer_torch import params_from_jax

    for name, value in params_from_jax(params).items():
        torch.testing.assert_close(tl.state_dict()[name], value, rtol=0, atol=0)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jl, params = _jax_params()
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_checkpoint(path, params, step=12, note="x")
    tl = checkpoint.load_checkpoint(path, cli._gene_pred_layer(8, "cpu"))
    init_j, A_j = jl.transitions.matrices(params["transitions"])
    init_t, A_t = tl.transitions.matrices()
    np.testing.assert_allclose(init_t.detach().numpy(), np.asarray(init_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(A_t.detach().numpy(), np.asarray(A_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tl.emissions[0].make_B().detach().numpy(),
        np.asarray(jl.emissions[0].make_B(params["emissions"][0])), rtol=1e-6, atol=0,
    )
    assert checkpoint.load_metadata(path) == {"note": "x", "step": 12}
    assert checkpoint.load_metadata(path[:-4]) == {"note": "x", "step": 12}


def test_port_checkpoint_loads_into_jax(tmp_path):
    _, params = _jax_params(1)
    tl = cli._gene_pred_layer(8, "cpu")
    from hmm_layer_torch import load_jax_params

    load_jax_params(tl, params)
    path = str(tmp_path / "sub" / "port")  # np.savez appends .npz
    checkpoint.save_checkpoint(path, tl, step=3)
    back = jckpt.load_checkpoint(path, like=params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert checkpoint.load_metadata(path) == {"step": 3}
    assert checkpoint.load_checkpoint(path, cli._gene_pred_layer(8, "cpu")) is not None


def test_checkpoint_refuses_missing_and_misshapen(tmp_path):
    tl = cli._gene_pred_layer(8, "cpu")
    path = str(tmp_path / "c.npz")
    state = {k.replace(".", "/"): v.numpy() for k, v in tl.state_dict().items()}
    missing = dict(state)
    missing.pop("transitions/transition_kernel")
    np.savez(path, **missing)
    with pytest.raises(KeyError, match="transition_kernel"):
        checkpoint.load_checkpoint(path, tl)
    bad = dict(state)
    bad["transitions/transition_kernel"] = np.zeros((1, 2), np.float32)
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_checkpoint(path, tl)
    assert checkpoint.load_metadata(str(tmp_path / "none.npz")) == {}


# ---------------------------------------------------------------------------
# predict end to end
# ---------------------------------------------------------------------------


def _read_gene_rows(path):
    """(seqid, strand, start, end, feature type) of every feature row."""
    rows = []
    for ln in Path(path).read_text().splitlines():
        if ln.startswith("#"):
            continue
        cols = ln.split("\t")
        rows.append((cols[0], cols[6], int(cols[3]), int(cols[4]), cols[2]))
    return rows


def _features(by_seq):
    out = []
    for seqid, genes in by_seq.items():
        for g in genes:
            out.append((seqid, g.strand, g.start, g.end, "gene"))
            out += [(seqid, g.strand, s, e, "CDS") for s, e, _ in g.cds]
            out += [(seqid, g.strand, s, e, "intron") for s, e in g.introns]
    return sorted(out)


def test_predict_matches_jax_cli(tmp_path):
    rng = np.random.default_rng(3)
    records = [("ctgA", _random_dna(rng, 2400)), ("ctgB", _random_dna(rng, 2377))]
    fasta = tmp_path / "contigs.fa"
    _write_fasta(fasta, records)
    probs = {}
    for name, seq in records:
        for key in (name, f"{name}__rc"):
            probs[key] = rng.dirichlet(np.ones(15) * 0.3, size=len(seq)).astype(np.float32)
    npz = tmp_path / "cls.npz"
    np.savez(npz, **probs)
    _, params = _jax_params(2)
    ckpt = str(tmp_path / "params.npz")
    jckpt.save_checkpoint(ckpt, params)

    common = ["-i", str(fasta), "--class-probs", str(npz), "--params", ckpt,
              "--window", "600", "--parallel-factor", "8", "--batch", "4",
              "--both-strands", "--cpu"]
    out_j, out_t = tmp_path / "jax.gff3", tmp_path / "torch.gff3"
    assert jax_cli.main(["predict", "-o", str(out_j), *common]) == 0
    assert cli.main(["predict", "-o", str(out_t), *common]) == 0
    got, ref = annotation.read_gff3(out_t), annotation.read_gff3(out_j)
    assert sum(len(g) for g in ref.values()) > 0
    assert _features(got) == _features(ref)
    assert sorted(_read_gene_rows(out_t)) == sorted(_read_gene_rows(out_j))


def _planted(strand):
    """A 32-bp contig with one planted gene (start, mid-exon, stop codons)
    and near-one-hot class probabilities on the gene's strand."""
    E0, E1, E2, ST, SP = 4, 5, 6, 7, 14
    true_path = np.zeros(32, np.int64)
    gene = [ST, E1, E2, E0, E1, E2, E0, E1, SP]
    true_path[10 : 10 + len(gene)] = gene
    bases = list(_random_dna(np.random.default_rng(2), 32))
    bases[10:13], bases[13:16], bases[16:19] = "ATG", "GCT", "TAA"
    planted = np.full((32, 15), 0.005, np.float32)
    planted[np.arange(32), true_path] = 1.0
    planted /= planted.sum(-1, keepdims=True)
    seq = "".join(bases)
    if strand == "+":
        return seq, {"ctg1": planted}
    intergenic = np.full((32, 15), 0.02, np.float32)
    intergenic[:, 0] = 0.72
    return data.revcomp(seq), {"ctg1": intergenic, "ctg1__rc": planted}


@pytest.mark.parametrize("strand,pf,expected", [("+", 1, ("11", "19", "+")),
                                                ("+", 4, ("11", "19", "+")),
                                                ("-", 1, ("14", "22", "-"))])
def test_predict_finds_a_planted_gene(tmp_path, strand, pf, expected):
    seq, probs = _planted(strand)
    fasta, npz, out = tmp_path / "dna.fa", tmp_path / "cls.npz", tmp_path / "out.gff3"
    _write_fasta(fasta, [("ctg1", seq)])
    np.savez(npz, **probs)
    argv = ["predict", "-i", str(fasta), "-o", str(out), "--class-probs", str(npz),
            "--window", "32", "--parallel-factor", str(pf), "--cpu"]
    if strand == "-":
        argv.append("--both-strands")
    assert cli.main(argv) == 0
    rows = [r for r in _read_gene_rows(out) if r[4] == "gene"]
    assert len(rows) == 1
    assert (str(rows[0][2]), str(rows[0][3]), rows[0][1]) == expected


def test_predict_uniform_prior_and_missing_key(tmp_path):
    fasta = tmp_path / "dna.fa"
    _write_fasta(fasta, [("ctg1", _random_dna(np.random.default_rng(1), 96))])
    out = tmp_path / "out.gff3"
    argv = ["predict", "-i", str(fasta), "-o", str(out), "--window", "48",
            "--overlap", "8", "--parallel-factor", "4", "--cpu"]
    assert cli.main(argv) == 0
    assert out.read_text().startswith("##gff-version 3\n")
    for row in _read_gene_rows(out):
        assert row[0] == "ctg1" and 1 <= row[2] <= row[3] <= 96
    npz = tmp_path / "cls.npz"
    np.savez(npz, other=np.zeros((96, 15), np.float32))
    with pytest.raises(KeyError, match="ctg1"):
        cli.main(argv + ["--class-probs", str(npz)])


def test_predict_runs_on_the_gpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta = tmp_path / "dna.fa"
    _write_fasta(fasta, [("ctg1", "ACGT" * 8)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["predict", "-i", str(fasta), "-o", str(tmp_path / "o.gff3")])
    args = cli.build_parser().parse_args(["predict", "-i", "a", "-o", "b"])
    assert (args.window, args.overlap, args.batch, args.parallel_factor, args.cpu) == \
        (1024, 64, 8, 8, False)


def test_new_modules_import_no_jax_and_no_cuda():
    code = (
        "import sys, torch, hmm_layer_torch\n"
        "from hmm_layer_torch import cli, data, viterbi\n"
        "from hmm_layer_torch.models import annotation, initializers\n"
        "from hmm_layer_torch.utils import checkpoint\n"
        "from hmm_layer_torch.ops import cuda_adjoint, cuda_mxu, cuda_viterbi, _cuda_build\n"
        "from hmm_layer_torch import training\n"
        "from hmm_layer_torch.utils import metrics, resilience\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('hmm_layer_tpu') for m in sys.modules)\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised at import'\n"
        "assert not _cuda_build._libs, 'kernels loaded at import'\n"
        "assert set(_cuda_build.SOURCES) == {'sum_product', 'max_plus', 'affine', 'mxu', 'max_plus_wide', 'sum_product_wide'}\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr


def test_module_entry_point_runs_predict(tmp_path):
    fasta = tmp_path / "dna.fa"
    _write_fasta(fasta, [("ctg1", "ACGT" * 8)])
    out = tmp_path / "o.gff3"
    proc = subprocess.run(
        [sys.executable, "-m", "hmm_layer_torch", "predict", "-i", str(fasta), "-o", str(out),
         "--window", "16", "--parallel-factor", "4", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    assert "wrote" in proc.stdout and out.read_text().startswith("##gff-version 3")
