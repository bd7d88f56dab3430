"""The share of decoded positions that are contig bp in the multi-copy
cell: the contig bp of the strands decoded over the positions of the
window batches decoded. Padding and fill windows are the rest, and each
costs the q = 505 decode's device time."""


def read(rec):
    return rec["window"]["window_fill_pct"]
