"""The yardstick's operation and byte counts against the kernel bounds of
PERF.md's kernel table (H100 SXM data sheet, the flagship shapes), and
the whole steps' counts against their textbook per-position figures."""

import pytest

from portbench import counts

FLAGSHIP = {"m": 1, "b": 32, "L": 9999, "q": 15, "P": 33, "s": 15}
H100 = "NVIDIA H100 80GB HBM3"

# kernel -> (bound ms, what bounds it), as PERF.md's table gives them.
TABLE = {
    counts.k1_sum_chunk_summaries: (0.0364, "operations"),
    counts.k2_sum_fwd_outputs: (0.0115, "bytes"),
    counts.k3_beta_bwd_outputs: (0.0115, "bytes"),
    counts.k4_affine_chunk_composites: (0.0734, "operations"),
    counts.k5_affine_reverse_outputs: (0.0459, "bytes"),
    counts.k6_maxplus_chunk_summaries: (0.0321, "operations"),
    counts.k7_maxplus_deltas: (0.0115, "bytes"),
    counts.k8_maxplus_backtrace: (0.0061, "bytes"),
}


@pytest.mark.parametrize("kernel", list(TABLE), ids=lambda f: f.__name__)
def test_kernel_bounds_match_the_table(kernel):
    ops, nbytes = kernel(FLAGSHIP)
    flops, bw = counts.peaks(H100)
    bound_ms, by = TABLE[kernel]
    assert 1e3 * counts.bound_s(ops, nbytes, H100) == pytest.approx(bound_ms, abs=6e-5)
    assert (ops / flops > nbytes / bw) == (by == "operations")


def test_peaks_follow_the_part():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert counts.peaks("NVIDIA H100 PCIe") == (51e12, 2.0e12)


def test_step_counts():
    per_pos = counts.ce_step_ops(FLAGSHIP) / (32 * 9999)
    assert per_pos == 12 * 15**2 + 2 * (2 * 15 * 15) + 4 * 64 * 9
    assert counts.decode_batch_ops(FLAGSHIP) / (32 * 9999) == 2 * 15**2 + 1 + 2 * 15 * 15 + 4 * 64 * 9
    profile = {"b": 64, "L": 400, "qs": [123, 131, 139, 147, 155], "s": 26}
    passes = sum(2 * q * q for q in profile["qs"])
    assert passes == 194_490
    assert counts.map_step_ops(profile) == 64 * 400 * (3 * passes + sum(4 * 26 * q for q in profile["qs"]))
