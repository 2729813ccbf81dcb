"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. Host time enqueuing the DP passes
(``timings["dp_s"] + timings["rev_disp_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("dp_s", "rev_disp_s"))
