"""Layer host process; unit GB; moves genotype_mbases_per_s. The process's
``ru_maxrss`` at the window's end."""


def read(ctx):
    return ctx["host_peak_bytes"] / 1e9
