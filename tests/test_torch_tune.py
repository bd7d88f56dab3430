"""The sweep of the chunk scans K1–K8, the blocked decode K7b, K8b and the
16 < q <= 128 chunk summaries K9 (``hmm_layer_torch/tune_scans.py``): what
it would build, the blocked kernels' and K9's cases, and that it needs a
card. The sweep itself runs on the card only."""

import re

import pytest
import torch

from hmm_layer_torch import tune_scans
from hmm_layer_torch.ops import _cuda_build, cuda_mxu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# kernel: (source, -D prefix, words a step of one element stages)
KERNELS = {"K1": ("sum_product", "SUM", 16), "K2": ("sum_product", "FWD", 16),
           "K3": ("sum_product", "BWD", 16), "K4": ("affine", "COMP", 48),
           "K5": ("affine", "OUT", 48), "K6": ("max_plus", "MPS", 16),
           "K7": ("max_plus", "DELTA", 16), "K8": ("max_plus", "TRACE", 16),
           "K7b": ("max_plus", "DBLK", None), "K8b": ("max_plus", "TBLK", None),
           "K9": ("mxu", "MXU", None)}
KEYS = ("G", "TS", "NB", "UNROLL")
BLOCKED_KEYS = {"K7b": ("S", "TS"), "K8b": ("T", "G")}
MXU_KEYS = ("TM", "TN", "TS", "G")


def _build_default(name, prefix, keys):
    src = _cuda_build.SOURCES[name].read_text()
    return {k: int(re.search(rf"#define {prefix}_{k} (\d+)", src).group(1)) for k in keys}


def _blocked_block(kernel, knobs):
    """(threads, static shared memory) of the blocked kernels at q = 64."""
    if kernel == "K7b":
        return 64 * knobs["S"], 4 * (2 * knobs["TS"] * 64 + 2 * 64)
    return 65 * knobs["G"], knobs["T"] * (4 * 64 + 80)


def _mxu_blocks(knobs):
    """(threads, dynamic shared memory) of K9's block at each padded width
    QP: G elements of (QP / TN) (QP / TM) threads at QP = 32, one element
    above (12 columns a thread at QP = 96); A (QP x QP), and per element
    two buffers of M (QP x QP) and two ring slots (TS x QP)."""
    out = {}
    for qp, g in ((32, knobs["G"]), (64, 1), (96, 1), (128, 1)):
        tn = 12 if qp == 96 else knobs["TN"]
        assert qp % tn == 0 and qp % knobs["TM"] == 0
        out[qp] = (g * (qp // tn) * (qp // knobs["TM"]),
                   4 * (qp * qp + g * (2 * qp * qp + 2 * knobs["TS"] * qp)))
    return out


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_sweep_covers_the_build_and_fits_shared_memory(kernel):
    name, prefix, words = KERNELS[kernel]
    keys = MXU_KEYS if kernel == "K9" else BLOCKED_KEYS.get(kernel, KEYS)
    variants = [v for v in tune_scans._variants(["parent"]) if v[4] == (kernel,) and v[3]]
    labels = [v[0] for v in variants]
    assert labels and len(labels) == len(set(labels))
    for lab, src_name, _, defs, _ in variants:
        assert src_name == name and all(d.startswith(f"-D{prefix}_") for d in defs), lab
        knobs = {d.split("=")[0][len(prefix) + 3:]: int(d.split("=")[1]) for d in defs}
        assert tuple(knobs) == keys, lab
        if kernel in BLOCKED_KEYS:  # static shared memory: 48 KB
            threads, smem = _blocked_block(kernel, knobs)
            assert smem <= 48 * 1024 and threads <= 1024, lab
        elif kernel == "K9":  # dynamic shared memory at every padded width
            blocks = _mxu_blocks(knobs)
            for qp, (t, b) in blocks.items():
                assert b <= tune_scans.SMEM_LIMIT and t <= 1024 and t % 32 == 0, (lab, qp)
                nc = qp // (12 if qp == 96 else knobs["TN"])
                assert nc <= 32 and nc & (nc - 1) == 0, (lab, qp)  # a row's threads: xor shuffles
            threads, smem = (max(v) for v in zip(*blocks.values()))
        else:
            g, ts, nb = knobs["G"], knobs["TS"], knobs["NB"]
            smem = 4 * nb * ts * g * words
            threads = 16 * g
            assert smem <= tune_scans.SMEM_LIMIT and threads <= 1024 and nb >= 2, lab
        if kernel in ("K4", "K6"):  # float4 tile reads: the swizzle keeps words whole only for G <= 8
            assert knobs["G"] in (1, 2, 4, 8), lab
        if kernel == "K7b":  # S adjacent lanes share a state's terms, read as float4 words
            assert knobs["S"] in (1, 2, 4), lab
        assert tune_scans.block_shape(kernel, knobs) == (threads, smem), lab
    default = _build_default(name, prefix, keys)
    assert default == tune_scans.build_defaults()[kernel]
    assert tune_scans.label(kernel, default) in labels


@pytest.mark.parametrize("kernels", [("K1", "K3"), ("K4", "K7"), ("K6", "K8"), ("K7b", "K8b"),
                                     ("K9",), tuple(KERNELS)])
def test_compare_builds_run_every_kernel_of_their_source(kernels):
    variants = tune_scans._variants(["parent"], grid=False, kernels=kernels)
    runs = {v[0]: v[4] for v in variants}
    want = {f"{KERNELS[k][0]} parent" for k in kernels}
    assert set(runs) == want
    assert sorted(k for r in runs.values() for k in r) == sorted(kernels)
    assert tune_scans._variants(["parent"], kernels=kernels)[-len(want):] == variants


def test_blocked_cases_hold_the_plain_versions(monkeypatch):
    """K7b's and K8b's cases (here on the CPU, at a small shape): the C
    shape arguments, sequence-major inputs and outputs, the plain results
    and bounds."""
    monkeypatch.setattr(tune_scans, "BLOCKED_SHAPE", dict(b=3, L=40, qs=(17, 33)))
    cases = tune_scans._cases(torch.device("cpu"), ("K7b", "K8b"))
    for kernel in ("K7b", "K8b"):
        assert [tag for tag, _ in cases[kernel]] == [" q=17", " q=33"]
        for (_, case), q in zip(cases[kernel], (17, 33)):
            ins, ref, own, rtol, atol, mask, bound, by, dims = case
            assert dims == (1, 40, q, 3) and (rtol, atol, mask) == (0.0, 0.0, None)
            assert tuple(ins[1].shape) == ((1, 3, 40, q))
            assert tuple(ref.shape) == ((1, 3, 40, q) if kernel == "K7b" else (1, 3, 40))
            assert torch.equal(ref, own) and bound > 0 and by in ("bytes", "operations")
    states = cases["K8b"][0][1][1]
    assert states.dtype == torch.int32 and int(states.min()) >= 0 and int(states.max()) < 17


def test_mxu_cases_hold_the_plain_version(monkeypatch):
    """K9's cases (here on the CPU, at a small shape): the C shape
    arguments (m, c, q, R, P), the inputs' layouts, the plain result, the
    tolerance and mask, and the bound."""
    monkeypatch.setattr(tune_scans, "MXU_SHAPE", dict(L=20, P=4, qb=((17, 3), (33, 2))))
    cases = tune_scans._cases(torch.device("cpu"), ("K9",))
    assert list(cases) == ["K9"] and [tag for tag, _ in cases["K9"]] == [" q=17", " q=33"]
    for (_, case), (q, b) in zip(cases["K9"], ((17, 3), (33, 2))):
        ins, ref, own, rtol, atol, mask, bound, by, dims = case
        R = 4 * b
        assert dims == (1, 5, q, R, 4) and (rtol, atol) == (2e-4, 2e-4)
        assert tuple(ins[0].shape) == (1, q, q) and tuple(ins[1].shape) == (1, 5, R, q)
        assert tuple(ref.shape) == (1, R, q, q) and torch.isfinite(ref).all()
        torch.testing.assert_close(ref, cuda_mxu.sum_chunk_summaries_mxu_plain(*ins, 4))
        assert torch.equal(ref, own) and mask.dtype == torch.bool and mask.any(-1).all()
        nops = R * q * 4 * q * (2 * q + 4)
        assert by == "operations" and bound == pytest.approx(1e3 * nops / tune_scans.PEAK_FLOPS)
        torch.testing.assert_close(ins[0].sum(-1), torch.ones(1, q))  # rows of A sum to 1
        assert float(ins[0][..., 1].abs().max()) == 0.0  # its structural zero column


def test_sweep_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("on a card the sweep runs for real (python3 -m hmm_layer_torch.tune_scans)")
    assert tune_scans.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tune_scans.main(["--e2e"])  # the A/B run needs one --compare directory
    with pytest.raises(SystemExit):
        tune_scans.main(["--kernels", "K10"])  # no kernel K10
