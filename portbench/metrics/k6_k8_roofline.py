"""The roofline share of K6-K8 together, the decode's kernels: the least
time of their launches in the profiled window, from the shapes, over
their device time."""

from portbench import counts, rooflines

KERNELS = {
    r"(?<![a-z_])chunk_summaries_kernel(?![a-z_])": counts.k6_maxplus_chunk_summaries,
    r"(?<![a-z_])deltas_kernel(?![a-z_])": counts.k7_maxplus_deltas,
    r"(?<![a-z_])backtrace_kernel(?![a-z_])": counts.k8_maxplus_backtrace,
}


def read(rec):
    return rooflines.share_pct(rec, KERNELS)
