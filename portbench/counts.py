"""Operations and bytes: the yardstick of the roofline and the peak shares.

Peaks are NVIDIA's data-sheet figures for one H100 (float32 outside the
tensor cores; HBM bandwidth), at the card's full power limit.

A kernel's least time counts each input byte once and each output byte
once, whatever the kernel reads again, against the bandwidth, or its
operations against the float32 peak, whichever is larger. The kernels'
shapes: ``m`` models, ``b`` rows, ``L`` positions, ``q`` states, ``P``
chunks of ``c = L / P`` positions, ``R = b P`` chunk rows. A fused
multiply-add counts as two operations.

A step's operations are the textbook sequential recursions the
configuration defines, per position and model: each forward, backward or
max-plus pass costs ``2 q^2`` (a q x q product), plus the emissions'
contractions; recomputation is not counted.
"""

from __future__ import annotations

PEAKS = {  # name fragment -> (float32 FLOP/s, bytes/s)
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),
}


def peaks(device_name: str):
    """(FLOP/s, bytes/s) of the card: the SXM part unless the name says
    PCIe or NVL."""
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return PEAKS[key]
    return PEAKS["H100"]


def bound_s(ops, nbytes, device_name):
    flops, bw = peaks(device_name)
    return max(ops / flops, nbytes / bw)


def peak_share_pct(ops, seconds, device_name):
    """Operations done in ``seconds`` as a share of the float32 peak."""
    return 100.0 * ops / (seconds * peaks(device_name)[0])


def _chunks(s):
    return s["m"], s["b"], s["L"], s["q"], s["P"], s["L"] // s["P"], s["b"] * s["P"]


# -- kernels (per launch) ----------------------------------------------------------


def k1_sum_chunk_summaries(s):
    """K1: every chunk row's q x q sum-product summary. Per step and state
    of a row: a q-term FMA row (2q), clamp, product, sum, divide (4).
    Reads A and E (m, c, q, R), writes the (m, R, q, q) summaries."""
    m, b, L, q, P, c, R = _chunks(s)
    return m * R * q * (c - 1) * q * (2 * q + 4), 4 * m * q * q + 4 * m * c * q * R + 4 * m * R * q * q


def k2_sum_fwd_outputs(s):
    """K2: the scaled forward pass of every chunk from its start. Reads A,
    E and the (m, R, q + 1) starts; writes log alpha (m, c, q, R)."""
    m, b, L, q, P, c, R = _chunks(s)
    return m * R * (c - 1) * q * (2 * q + 4), 4 * m * q * q + 2 * 4 * m * c * q * R + 4 * m * (q + 1) * R


def k3_beta_bwd_outputs(s):
    """K3: the scaled backward pass of every chunk; as K2."""
    return k2_sum_fwd_outputs(s)


def k4_affine_chunk_composites(s):
    """K4: the adjoint's chunk composites over the doubled model (2m):
    per step and each of the q + 1 columns a q x q product and two
    q-vector scalings. Reads B and u, v, the source (3 x (2m, c, q, R));
    writes (2m, R, q, q + 1)."""
    m, b, L, q, P, c, R = _chunks(s)
    m2 = 2 * m
    ins = 3 * 4 * m2 * c * q * R + 4 * m2 * q * q
    return m2 * R * (q + 1) * c * (2 * q * q + 2 * q), ins + 4 * m2 * R * q * (q + 1)


def k5_affine_reverse_outputs(s):
    """K5: the adjoint's outputs over the doubled model: per step a q x q
    product and three q-vector operations. Reads as K4 and the (2m, q, R)
    right ends; writes (2m, c, q, R)."""
    m, b, L, q, P, c, R = _chunks(s)
    m2 = 2 * m
    ins = 3 * 4 * m2 * c * q * R + 4 * m2 * q * q
    return m2 * R * c * (2 * q * q + 3 * q), ins + 4 * m2 * q * R + 4 * m2 * c * q * R


def k6_maxplus_chunk_summaries(s):
    """K6: every chunk row's max-plus summary; per term an add and a max.
    Reads log A and log E; writes (m, R, q, q)."""
    m, b, L, q, P, c, R = _chunks(s)
    return m * R * q * (c - 1) * 2 * q * q, 4 * m * q * q + 4 * m * c * q * R + 4 * m * R * q * q


def k7_maxplus_deltas(s):
    """K7: the max-plus pass of every chunk from its start. Reads log A,
    log E and the starts; writes the deltas (m, c, q, R)."""
    m, b, L, q, P, c, R = _chunks(s)
    return m * R * (c - 1) * 2 * q * q, 4 * m * q * q + 2 * 4 * m * c * q * R + 4 * m * q * R


def k8_maxplus_backtrace(s):
    """K8: the backtrace of every chunk: an add and a max per state and
    step. Reads log A, the deltas and the last states; writes the states
    (m, c, R)."""
    m, b, L, q, P, c, R = _chunks(s)
    return m * R * (c - 1) * 2 * q, 4 * m * q * q + 4 * m * c * q * R + 4 * m * R + 4 * m * c * R


# -- whole steps (per step or batch) -------------------------------------------------

CODON_CLASSES, CONSTRAINED = 64, 9


def gene_emission_ops(s):
    """Per position: the class contraction (2 s q) and the codon factors'
    two 3-mer contractions (2 x 2 x 64 x 9)."""
    return 2 * s["s"] * s["q"] + 2 * 2 * CODON_CLASSES * CONSTRAINED


def ce_step_ops(s):
    """One posterior cross-entropy training step: the posterior's forward
    and backward passes (2 x 2q^2), the adjoint's two passes over the
    doubled model (2 x 2 x 2q^2), the emissions forward and the class
    contraction's gradient (2 s q), per position of every model."""
    per_pos = s["m"] * (12 * s["q"] ** 2 + 2 * s["s"] * s["q"]) + gene_emission_ops(s)
    return s["b"] * s["L"] * per_pos


def decode_batch_ops(s):
    """One decoded window batch: a max-plus pass (2q^2), the backtrace (1)
    and the emissions, per position."""
    return s["b"] * s["L"] * (s["m"] * (2 * s["q"] ** 2 + 1) + gene_emission_ops(s))


def map_step_ops(s):
    """One MAP training step of profile models of sizes ``qs``: the loss's
    forward pass and its gradient's forward and backward passes (3 x
    2 q_i^2), the emission contraction forward and its gradient (2 x 2 s
    q_i), per position of every model. The priors' O(q) terms are left
    out."""
    per_pos = sum(3 * 2 * q * q + 2 * 2 * s["s"] * q for q in s["qs"])
    return s["b"] * s["L"] * per_pos
