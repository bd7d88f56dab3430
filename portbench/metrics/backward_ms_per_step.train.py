"""Host milliseconds a step in the profiled window of the training step's
gradients: the whole ``hmm.train.backward`` spans."""

from portbench import spans


def read(rec):
    return spans.ms_per_unit(rec, "hmm.train.backward")
