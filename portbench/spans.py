"""The port's own spans, as the per-layer metrics read them.

A span of the port (``hmm_layer_torch.utils.profiling.span``) records only
while a ``torch.profiler`` profile runs, so after a ``--trace 1`` run
``recorded_spans()`` holds the spans of the profiled window: the measured
window, with no profile, opened none, and the profiled window's first span
dropped every older record. :func:`ms_per_unit` turns them into
milliseconds a unit of the profiled work (a window batch, a step). A
program without the span recorder, or a window that opened no span of
the name, gives None and the metric is left out.
"""

from __future__ import annotations

from collections import defaultdict


def recorded():
    """The port's records of the profiled window; [] where it keeps none."""
    from hmm_layer_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    return [r for r in read() if r.end_ns is not None] if read else []


def _covered(intervals):
    """Nanoseconds covered by the union of (start, end) intervals."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def seconds(records, own=False):
    """Seconds by span name: each span's whole duration, or with ``own``
    its duration less the union of its children's."""
    children = defaultdict(list)
    if own:
        for r in records:
            if r.parent is not None:
                children[r.parent].append(r)
    out = defaultdict(float)
    for i, r in enumerate(records):
        ns = r.end_ns - r.start_ns
        if own:
            ns -= _covered((max(c.start_ns, r.start_ns), min(c.end_ns, r.end_ns)) for c in children[i])
        out[r.name] += ns * 1e-9
    return dict(out)


def ms_per_unit(rec, name, own=False):
    """Milliseconds of the spans ``name`` (their own time with ``own``) a
    unit of the profiled work; None where the window opened none of them
    (nothing was measured), as where the program records no span."""
    records = recorded()
    if not any(r.name == name for r in records):
        return None
    return 1e3 * seconds(records, own)[name] / rec["trace"]["units"]
