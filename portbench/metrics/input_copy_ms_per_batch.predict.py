"""Host milliseconds a window batch in the profiled window of the host blocked
on each batch's copy to the device (pageable on a card): the own time of the
``hmm.layer.inputs`` spans."""

from portbench import spans


def read(rec):
    return spans.ms_per_unit(rec, "hmm.layer.inputs", own=True)
