"""The genome-annotation traffic of a multi-copy gene model:
``drivers/predict.py``'s closed loop of contig strands through
``cli.decode_contig``, its timed loop unchanged (so ``predict_bp_per_s``
means the same in both cells), with a check and a profiled window sized
for q = 1 + 14k states.

The check judges every window of the first strand that the measured
window decoded, and ``check_sample`` windows that the seed draws from the
other distinct tracks, by the reference's float64 decode: a dense step in
float64 costs ~2 MB a window at q = 505, so judging every window of every
strand would take hours, and this sample takes seconds. The profiled
window of a ``--trace 1`` run is one window batch: the forward strand of
the ladder's shortest contig.

Traffic file keys: ``kind`` ("predict_multicopy"), ``contigs``,
``min_bp``, ``max_bp`` (the ladder), ``window``, ``overlap``, ``batch``,
``check_block`` (windows per block of the reference's decode),
``check_sample``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, seeds
from portbench.drivers.predict import Run as PredictRun
from portbench.drivers.predict import window_inputs, windows_of
from portbench.reference import genepred_multicopy as ref
from portbench.reference import hmm
from portbench.reference.hmm import F64


class Run(PredictRun):
    def traced(self, profile):
        def work():
            n0 = len(self.batch_ms)
            with torch.inference_mode():
                self._forward_strand(0)
            return len(self.batch_ms) - n0

        return profile(work)

    def _forward_strand(self, i):
        """Contig ``i``'s forward strand, decoded as the timed loop decodes
        a strand."""
        _, nuc, cls_f, _ = self.contigs[i]
        self.prev_end = time.perf_counter()
        track = self.cli.decode_contig(self.viterbi_fn, nuc, cls_f, self.window_len, self.batch, self.overlap)
        self.answers.append((i, "+", track))

    # -- the check ---------------------------------------------------------------

    def check(self, limits, prec=F64):
        """The judged windows of the run's distinct tracks (see the module's
        docstring), each by the reference's float64 decode."""
        problems = self.distinct_tracks()
        rows = self.check_rows(problems)
        gaps = self.gaps_of(problems, rows, [problems[k][2][lo:hi] for k, _, lo, hi in rows], prec)
        widest = {}
        for (k, _, _, _), g in zip(rows, gaps):
            widest[k] = max(widest.get(k, 0.0), g)
        self.failed = sum(problems[k][3] for k, g in widest.items() if g > limits["path_gap_nats"])
        readings = {"path_gap_nats": max(widest.values())}
        detail = {"tracks_compared": len(widest), "windows_compared": len(rows), "answers": len(self.answers)}
        return checks.judged(readings, limits), detail

    def distinct_tracks(self):
        """(contig, strand, track, occurrences) of each distinct track of
        the run, the first strand of the measured window first."""
        distinct = {}
        for i, strand, track in self.answers:
            distinct.setdefault((i, strand, track.tobytes()), []).append(track)
        return [(i, strand, tracks[0], len(tracks)) for (i, strand, _), tracks in distinct.items()]

    def check_rows(self, problems):
        """(problem, start, kept from, kept to) of each judged window: every
        window of the first problem, then ``check_sample`` windows of the
        others drawn by the seed, in their order."""

        def rows_of(k):
            return [(k, st, lo, hi) for st, lo, hi in windows_of(len(problems[k][2]), self.window_len, self.overlap)]

        rest = [r for k in range(1, len(problems)) for r in rows_of(k)]
        n = min(self.traffic["check_sample"], len(rest))
        drawn = sorted(seeds.rng(self.ctx.seed, "check").choice(len(rest), n, replace=False))
        return rows_of(0) + [rest[j] for j in drawn]

    def blocks(self, problems, rows):
        """(first row, the rows' inputs (n, window, 20) on the device) of
        each block of ``check_block`` rows."""
        block, cached = self.traffic["check_block"], {}

        def inputs_of(k):  # the rows run problem by problem: one strand's arrays at a time
            if k not in cached:
                cached.clear()
                cached[k] = self.strand_inputs(*problems[k][:2])
            return cached[k]

        for b0 in range(0, len(rows), block):
            x = np.stack([window_inputs(*inputs_of(k), st, self.window_len) for k, st, _, _ in rows[b0 : b0 + block]])
            yield b0, torch.as_tensor(x, device=self.ctx.device)

    def reference_model(self, prec):
        """(params, init, A) of the seeded weights in ``prec``."""
        p = {k: v.to(prec.dtype) for k, v in self.params0.items()}
        return (p, *ref.matrices(p, self.family.copies(self.cfg), prec))

    def gaps_of(self, problems, rows, pins, prec=F64):
        """Per row, the gap between the reference's best path score of the
        window and the best score of the paths that take the states
        ``pins[row]`` at the window's kept positions."""
        k = self.family.copies(self.cfg)
        q = ref.num_states(k)
        p, init, A = self.reference_model(prec)
        codons = self.family.codons(self.cfg)
        self.window_gaps = []
        for b0, x in self.blocks(problems, rows):
            part = rows[b0 : b0 + len(x)]
            allowed = np.ones((len(part), self.window_len, q), bool)
            for r, (_, st, lo, hi) in enumerate(part):
                allowed[r, lo - st : hi - st] = False
                allowed[r, np.arange(lo - st, hi - st), pins[b0 + r]] = True
            with torch.no_grad():
                E = ref.emissions(p, x, codons, k, prec)
                best = hmm.viterbi_score(init, A, E)
                pinned = hmm.viterbi_score(init, A, E, torch.as_tensor(allowed, device=x.device))
                gap = (best - pinned).double().cpu().numpy()
            self.window_gaps.extend(float(g) if np.isfinite(g) else float("inf") for g in gap)
            del E
        return self.window_gaps
