"""Layer device memory; unit GB; moves genotype_mbases_per_s.
``torch.cuda.max_memory_allocated`` over the window."""


def read(ctx):
    peak = ctx["device_peak_bytes"]
    return None if peak is None else peak / 1e9
