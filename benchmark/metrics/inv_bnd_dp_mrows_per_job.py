"""Layer kernels K1 + K1' (``kernels/band_dp_v3``); unit millions of rows;
moves genotype_mbases_per_s. The DP rows handed to K1 and K1' on windows
whose panel path owns an INV or BND link: the program's counters
``dp_rows_inv_bnd`` (Σ m of the forward pass's kept windows) and
``rev_rows_inv_bnd`` (Σ (qe + 1) of the reverse pass's winners), per job.
A program without the counters reads nothing."""

KEYS = ("dp_rows_inv_bnd", "rev_rows_inv_bnd")


def read(ctx):
    rows = [sum(j.timings[k] for k in KEYS) if all(
        k in j.timings for k in KEYS) else None for j in ctx["jobs"]]
    if not rows or None in rows:
        return None
    return sum(rows) / len(rows) / 1e6
