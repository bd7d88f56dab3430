"""Host milliseconds a step in the profiled window of the training step's
optimizer update and gradient reset: the whole ``hmm.train.optimizer``
spans."""

from portbench import spans


def read(rec):
    return spans.ms_per_unit(rec, "hmm.train.optimizer")
