"""The training traffic: a closed loop of ``Trainer.fit`` steps.

Set-up builds one ``Trainer`` over the port's layer with the seeded
weights, and drives it through its first three steps, each a
``fit([batch])`` on a different batch of the pool: they warm every shape
up, and the check follows them with the reference. The window hands the
same trainer an iterator that cycles the rest of the pool and stops at the
deadline; one host sync ends it.

Traffic file keys: ``kind`` ("train"), ``pool`` (batches made in set-up),
``lr`` (Adam's learning rate), ``trace_steps`` (steps in the profiled
window of a ``--trace 1`` run).
"""

from __future__ import annotations

import functools
import time

import torch

from portbench import checks
from portbench.reference.hmm import F64

FIRST_STEPS = 3
BETA1 = 0.9


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic, self.family = ctx.cfg, ctx.traffic, ctx.family
        shape = self.cfg["shape"]
        self.positions_per_step = shape["batch"] * shape["length"]

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from hmm_layer_torch import Trainer

        ctx, fam = self.ctx, self.family
        self.params0 = fam.make_params(self.cfg, ctx.seed, ctx.device)
        self.pool = fam.make_train_pool(self.cfg, self.traffic, self.params0, ctx.seed, ctx.device)
        ctx.mark("weights and batches")
        self.layer = fam.build_program(self.cfg, self.params0, ctx.device)
        ctx.mark("the layer")
        optimizer = functools.partial(torch.optim.Adam, lr=self.traffic["lr"])
        loss_fn = fam.program_loss(self.layer)
        self.trainer = Trainer(self.layer, optimizer=optimizer, loss_fn=ctx.faults.wrap_loss(loss_fn, self.layer))
        names = {id(p): n for n, p in self.layer.named_parameters()}
        losses = []
        for j in range(FIRST_STEPS):
            if j == 0:
                self.trainer.init_from_params()
                ctx.faults.wrap_optimizer(self.trainer.optimizer)
            losses.append(float(self.trainer.fit([self.pool[j]]).detach()))
            ctx.mark(f"first step {j + 1}")
            if j == 0:
                state = self.trainer.optimizer.state
                grad1 = {names[id(p)]: (s["exp_avg"] / (1.0 - BETA1)).double().cpu() for p, s in state.items()}
        with torch.no_grad():
            change = {n: (p.double() - self.params0[n].double()).cpu()
                      for n, p in self.layer.named_parameters() if p.requires_grad}
        self.first = {"losses": losses, "grad1": grad1, "change": change}
        self.trainable = sorted(change)
        ctx.sync()

    # -- the measured window ---------------------------------------------------

    def _feed(self, start, stop_at=None, steps=None):
        pool, n = self.pool, len(self.pool)

        def gen():
            j = start
            while (steps is None or j - start < steps) and (stop_at is None or time.perf_counter() < stop_at):
                self.done += 1
                yield pool[j % n]
                j += 1

        return gen()

    def window(self, seconds):
        ctx = self.ctx
        self.done = 0
        ctx.sync()
        t0 = time.perf_counter()
        loss = self.trainer.fit(self._feed(FIRST_STEPS, stop_at=t0 + seconds))
        ctx.sync()
        t1 = time.perf_counter()
        self.window_steps, self.window_s = self.done, t1 - t0
        self.finite = bool(torch.isfinite(loss))
        return {
            "train_positions_per_s": self.done * self.positions_per_step / (t1 - t0),
            "steps": self.done,
            "window_s": t1 - t0,
        }

    def traced(self, profile):
        """A fixed number of steps under the profiler: the trace reduction."""
        steps = self.traffic["trace_steps"]
        self.done = 0

        def work():
            self.trainer.fit(self._feed(FIRST_STEPS + self.window_steps, steps=steps))
            return self.done

        return profile(work)

    def counts(self):
        return {"attempted": self.window_steps, "failed": 0 if self.finite else self.window_steps}

    def release(self):
        del self.trainer, self.layer
        self.pool = self.pool[:FIRST_STEPS]

    # -- the check ---------------------------------------------------------------

    def check(self, limits, prec=F64):
        """The program's first steps against the reference's, from the same
        weights on the same batches."""
        loss_fn = self.family.reference_loss(self.cfg)
        ref = checks.adam_follow(loss_fn, self.params0, self.pool[:FIRST_STEPS], self.trainable,
                                 self.traffic["lr"], prec)
        readings, detail = checks.training_readings(self.first, ref)
        detail["readings"] = readings
        return checks.judged(readings, limits), detail
