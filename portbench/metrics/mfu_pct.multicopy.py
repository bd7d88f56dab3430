"""The multi-copy decode's share of the card's float32 peak: the operations
the window batches of the measured window need (the family's ``unit_ops``,
``portbench.counts``' textbook yardstick at the configuration's q, P = 1)
over the window's time and the peak."""

from portbench import counts


def read(rec):
    if rec["device_name"] == "cpu":  # a peak share is a device's
        return None
    w = rec["window"]
    return counts.peak_share_pct(rec["unit_ops"] * w["batches"], w["window_s"], rec["device_name"])
