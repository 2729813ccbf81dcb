"""Layer kernel D1 (``kernels/dev_scan``); unit %; moves
genotype_mbases_per_s. The least time of the chunks' minimizer scans over
D1's device time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("D1",))
