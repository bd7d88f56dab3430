"""Host milliseconds a window batch in the profiled window of the copy of each
batch's kept positions into the strand's track: the own time of the
``hmm.predict.stitch`` spans."""

from portbench import spans


def read(rec):
    return spans.ms_per_unit(rec, "hmm.predict.stitch", own=True)
