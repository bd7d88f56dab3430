"""Host milliseconds a window batch in the profiled window of
``decode_contig``'s windowing: the own time of the ``hmm.predict.windows``
spans (the generator's step to each batch, the class rows, the
concatenation)."""

from portbench import spans


def read(rec):
    return spans.ms_per_unit(rec, "hmm.predict.windows", own=True)
