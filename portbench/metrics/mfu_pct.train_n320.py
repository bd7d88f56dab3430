"""The q = 639-647 profile training step's share of the card's float32
peak: the operations the steps of the measured window need
(portbench.counts) over the window's time and the peak."""

from portbench import counts


def read(rec):
    if rec["device_name"] == "cpu":  # a peak share is a device's
        return None
    w = rec["window"]
    return counts.peak_share_pct(rec["unit_ops"] * w["steps"], w["window_s"], rec["device_name"])
