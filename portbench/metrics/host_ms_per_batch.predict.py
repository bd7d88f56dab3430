"""The host's milliseconds per window batch: the window's time outside the
spans around the layer's decode (windowing, stacking, stitching, the
reverse complement), over the batches."""


def read(rec):
    return rec["window"]["host_ms_per_batch"]
