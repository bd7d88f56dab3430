"""The 95th percentile over all window batches of the measured window:
from the previous batch's paths on the host (or the strand's call) to
this batch's paths on the host. The first batch of a strand carries the
reverse complement and the strand's set-up, so the tail is the host's."""


def read(rec):
    return rec["window"]["batch_ms_p95"]
