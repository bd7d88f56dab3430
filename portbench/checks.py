"""The numbers that decide ``correct``, each compared with its limit.

Training (the first steps that the reference follows, program against
reference):

* ``loss_rel``: the widest relative gap between the program's and the
  reference's loss over those steps.
* ``grad_norm_gap``: the first gradient as the optimizer got it (Adam's
  first moment after one step over ``1 - beta1``); per leaf the gap
  between the two norms, over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the worst leaf.
* ``update_norm_gap``: the same for the parameters' change after those
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf with no gradient moves under Adam by
  round-off alone).
* ``grad_median_gap``, ``update_median_gap``: the median leaf's gap of
  either, steady from seed to seed where the worst leaf's swings.

A cell's limits file names the numbers it compares; the rest are
printed with the run's detail.

Decoding: ``path_gap_nats``, the widest gap, over every window the
program decoded, between the reference's best path score and the best
score of the paths that agree with the program's track where the track
takes that window's states.
"""

from __future__ import annotations

import statistics

import torch

LEAF_FLOOR = 1e-3


def adam_follow(loss_fn, params0, batches, trainable, lr, prec, beta1=0.9, beta2=0.999, eps=1e-8):
    """The reference's steps: autograd gradients of ``loss_fn`` and Adam,
    one step per batch of ``batches``, from ``params0``, in ``prec``. Returns
    {"losses", "grad1", "change"} as the program's are recorded."""
    p = {n: v.detach().to(prec.dtype).clone() for n, v in params0.items()}
    m = {n: torch.zeros_like(p[n]) for n in trainable}
    v = {n: torch.zeros_like(p[n]) for n in trainable}
    losses, grad1 = [], None
    for t, batch in enumerate(batches, 1):
        for n in trainable:
            p[n].requires_grad_(True)
        loss = loss_fn(p, batch, prec)
        grads = torch.autograd.grad(loss, [p[n] for n in trainable])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(trainable, grads):
                m[n] = beta1 * m[n] + (1 - beta1) * g
                v[n] = beta2 * v[n] + (1 - beta2) * g * g
                step = lr * (m[n] / (1 - beta1**t)) / (torch.sqrt(v[n] / (1 - beta2**t)) + eps)
                p[n] = p[n].detach() - step
        if t == 1:
            grad1 = {n: g.detach().double().cpu() for n, g in zip(trainable, grads)}
        del loss, grads
    change = {n: (p[n].detach().double() - params0[n].double()).cpu() for n in trainable}
    return {"losses": losses, "grad1": grad1, "change": change}


def leaf_gaps(prog, ref, leaves):
    """Per leaf, the gap between the two norms over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    norms_p = {n: float(prog[n].norm()) for n in leaves}
    norms_r = {n: float(ref[n].norm()) for n in leaves}
    median = statistics.median(norms_r.values())
    return {n: abs(norms_p[n] - norms_r[n]) / max(norms_r[n], median, 1e-300) for n in leaves}


def training_readings(prog, ref):
    """(readings {name: value}, detail): every training number and the
    leaves behind the worst ones."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if any(a != a for a in prog["losses"]):
        loss_rel = float("inf")
    leaves = sorted(ref["grad1"])
    grad = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    g_ref = {n: float(ref["grad1"][n].norm()) for n in leaves}
    floor = LEAF_FLOOR * statistics.median(g_ref.values())
    moved = [n for n in leaves if g_ref[n] >= floor]
    update = leaf_gaps(prog["change"], ref["change"], moved)
    readings = {
        "loss_rel": loss_rel,
        "grad_norm_gap": max(grad.values()),
        "grad_median_gap": statistics.median(grad.values()),
        "update_norm_gap": max(update.values()),
        "update_median_gap": statistics.median(update.values()),
    }
    detail = {"losses": prog["losses"], "ref_losses": ref["losses"], "grad_leaf": max(grad, key=grad.get),
              "update_leaf": max(update, key=update.get), "leaves_left_out": sorted(set(leaves) - set(moved))}
    return _nan_to_inf(readings), detail


def _nan_to_inf(readings):
    return {k: (float("inf") if v != v else v) for k, v in readings.items()}


def judged(readings, limits):
    """[{"name", "value", "limit"}] for every number that has a limit."""
    return [{"name": k, "value": readings[k], "limit": limits[k]} for k in limits]
