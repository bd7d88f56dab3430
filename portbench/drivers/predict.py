"""The genome-annotation traffic: a closed loop of contig strands through
``cli.decode_contig``, as ``predict --both-strands`` decodes them.

Set-up makes the pool of seeded contigs (lengths on a fixed ladder, the
content from the seed), the port's layer with the seeded weights, and
decodes one window batch to warm the one shape the traffic uses. The
window walks the pool's strands (forward, then the reverse complement of
each contig) in an order shuffled by the seed, and stops between strands at
the deadline. The layer's decode is wrapped in a span that brings the
paths to the host; the batch times and the host's share come from those
spans.

Traffic file keys: ``kind`` ("predict"), ``contigs``, ``min_bp``,
``max_bp`` (the ladder), ``window``, ``overlap``, ``batch``,
``trace_strands`` (strands in the profiled window of a ``--trace 1``
run), ``check_block`` (windows per block of the reference's decode).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import checks, seeds
from portbench.reference import genepred as ref
from portbench.reference import hmm
from portbench.reference.hmm import F64


def windows_of(length, window, overlap):
    """The windows ``decode_contig`` decodes: (start, kept from, kept to)
    for every window of a strand of ``length``."""
    stride = window - overlap
    out = []
    for st in range(0, max(length - overlap, 1), stride):
        lo = st + overlap if st > 0 else st
        out.append((st, lo, min(st + window, length)))
    return out


def window_inputs(nuc, cls, st, window):
    """(window, 20): the class rows (uniform past the end) and the
    nucleotides (zeros past the end) of the window at ``st``."""
    x = np.zeros((window, 20), np.float32)
    x[:, :15] = 1.0 / 15.0
    n = min(window, len(nuc) - st)
    x[:n, :15] = cls[st : st + n]
    x[:n, 15:] = nuc[st : st + n]
    return x


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic, self.family = ctx.cfg, ctx.traffic, ctx.family
        t = self.traffic
        self.window_len, self.overlap, self.batch = t["window"], t["overlap"], t["batch"]

    def setup(self):
        from hmm_layer_torch import cli, data

        self.cli, self.data = cli, data
        ctx = self.ctx
        self.params0 = self.family.make_params(self.cfg, ctx.seed, ctx.device)
        self.contigs = self.family.make_contigs(self.traffic, ctx.seed, ctx.device)
        ctx.mark("weights and contigs")
        self.layer = self.family.build_program(self.cfg, self.params0, ctx.device)
        ctx.mark("the layer")
        strands = [(i, s) for i in range(len(self.contigs)) for s in "+-"]
        self.order = [strands[k] for k in seeds.rng(ctx.seed, "order").permutation(len(strands))]
        self.next = 0
        self.spans, self.batch_ms, self.answers, self.failed = [], [], [], 0
        self.viterbi_fn = ctx.faults.wrap_viterbi(self._viterbi)
        with torch.inference_mode():
            wins, _ = next(data.window_batches(self.contigs[0][1], self.window_len, self.batch, self.overlap))
            cls = np.full(wins.shape[:2] + (15,), 1.0 / 15.0, np.float32)
            self.layer.viterbi(np.concatenate([cls, wins], -1)[None]).cpu()
        ctx.sync()
        ctx.mark("the warm-up batch")

    def _viterbi(self, x):
        t_a = time.perf_counter()
        paths = self.layer.viterbi(x).cpu()
        t_b = time.perf_counter()
        self.spans.append(t_b - t_a)
        self.batch_ms.append(1e3 * (t_b - self.prev_end))
        self.prev_end = t_b
        return paths

    def _strand(self):
        i, strand = self.order[self.next % len(self.order)]
        self.next += 1
        _, nuc, cls_f, cls_r = self.contigs[i]
        self.prev_end = time.perf_counter()
        enc = nuc if strand == "+" else self.data.revcomp_onehot(nuc)
        track = self.cli.decode_contig(self.viterbi_fn, enc, cls_f if strand == "+" else cls_r,
                                       self.window_len, self.batch, self.overlap)
        self.answers.append((i, strand, track))
        return len(track)

    def window(self, seconds):
        ctx = self.ctx
        ctx.sync()
        bp, n0 = 0, len(self.answers)
        t0 = time.perf_counter()
        with torch.inference_mode():
            while time.perf_counter() < t0 + seconds:
                bp += self._strand()
        t1 = time.perf_counter()
        elapsed, batches = t1 - t0, len(self.batch_ms)
        self.strands = len(self.answers) - n0
        return {
            "predict_bp_per_s": bp / elapsed,
            "batch_ms_p95": statistics.quantiles(self.batch_ms, n=20, method="inclusive")[-1],
            "host_ms_per_batch": 1e3 * (elapsed - sum(self.spans)) / batches,
            "window_fill_pct": 100.0 * bp / (batches * self.batch * self.window_len),
            "batches": batches,
            "strands": self.strands,
            "window_s": elapsed,
        }

    def traced(self, profile):
        def work():
            n0 = len(self.batch_ms)
            with torch.inference_mode():
                for _ in range(self.traffic["trace_strands"]):
                    self._strand()
            return len(self.batch_ms) - n0

        return profile(work)

    def counts(self):
        return {"attempted": len(self.answers), "failed": self.failed}

    def release(self):
        del self.layer

    # -- the check ---------------------------------------------------------------

    def check(self, limits, prec=F64):
        """Every strand decoded in the run, judged window by window by the
        reference's float64 decode (each distinct track of a strand once)."""
        distinct = {}
        for i, strand, track in self.answers:
            distinct.setdefault((i, strand, track.tobytes()), []).append(track)
        problems = [(i, strand, tracks[0], len(tracks)) for (i, strand, _), tracks in distinct.items()]
        gap_by_answer = self.decode_gaps(problems, prec)
        self.failed = sum(n for g, n in gap_by_answer if g > limits["path_gap_nats"])
        readings = {"path_gap_nats": max(g for g, _ in gap_by_answer)}
        detail = {"tracks_compared": len(problems), "answers": len(self.answers)}
        return checks.judged(readings, limits), detail

    def strand_inputs(self, i, strand):
        _, nuc, cls_f, cls_r = self.contigs[i]
        if strand == "+":
            return nuc, cls_f
        return np.ascontiguousarray(nuc[::-1, [3, 2, 1, 0, 4]]), cls_r

    def decode_gaps(self, problems, prec=F64):
        """(widest window gap, occurrences) per (contig, strand, track,
        occurrences) problem."""
        device = self.ctx.device
        p64 = {k: v.to(prec.dtype) for k, v in self.params0.items()}
        init, A = ref.matrices(p64, prec)
        codons = self.family.codons(self.cfg)
        rows = []  # (problem index, start, lo, hi)
        for k, (i, strand, track, _) in enumerate(problems):
            for st, lo, hi in windows_of(len(track), self.window_len, self.overlap):
                rows.append((k, st, lo, hi))
        widest = [0.0] * len(problems)
        self.window_gaps = []
        block = self.traffic["check_block"]
        cached = {}

        def inputs_of(k):  # the rows run strand by strand: one strand's arrays at a time
            if k not in cached:
                cached.clear()
                cached[k] = self.strand_inputs(*problems[k][:2])
            return cached[k]

        for b0 in range(0, len(rows), block):
            part = rows[b0 : b0 + block]
            x = np.stack([window_inputs(*inputs_of(k), st, self.window_len) for k, st, _, _ in part])
            allowed = np.ones((len(part), self.window_len, ref.NUM_STATES), bool)
            for r, (k, st, lo, hi) in enumerate(part):
                pinned = problems[k][2][lo:hi]
                allowed[r, lo - st : hi - st] = False
                allowed[r, np.arange(lo - st, hi - st), pinned] = True
            with torch.no_grad():
                E = ref.emissions(p64, torch.as_tensor(x, device=device), codons, False, prec)
                best = hmm.viterbi_score(init, A, E)
                pinned = hmm.viterbi_score(init, A, E, torch.as_tensor(allowed, device=device))
                gap = (best - pinned).double().cpu().numpy()
            for r, (k, _, _, _) in enumerate(part):
                widest[k] = max(widest[k], float(gap[r]) if np.isfinite(gap[r]) else float("inf"))
            self.window_gaps.extend(gap.tolist())
            del E
        return [(widest[k], problems[k][3]) for k in range(len(problems))]
