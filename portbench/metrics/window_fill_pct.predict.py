"""The share of decoded positions that are contig bp: the contig bp of
the strands decoded over the positions of the window batches decoded
(padding and fill windows are the rest)."""


def read(rec):
    return rec["window"]["window_fill_pct"]
