"""Layer device (one H100); unit %; moves genotype_mbases_per_s. 100 minus
the busy share: the union of the trace's kernel, memcpy and memset
intervals over the traced window of whole jobs."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
