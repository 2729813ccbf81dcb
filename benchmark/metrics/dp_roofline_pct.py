"""Layer kernels K1 + K1' (``kernels/band_dp_v3``); unit %; moves
genotype_mbases_per_s. The least time of the forward candidates' and the
reverse winners' DP over K1's and K1''s device time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("K1", "K1'"))
