"""Layer kernel A1 (``kernels/band_dp_stats``); unit %; moves
genotype_mbases_per_s. The least time of the audit's pieces over A1's
device time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("A1",))
