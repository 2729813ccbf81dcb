"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. Host time waiting for the DP passes' results
(``timings["fwd_exec_s"] + timings["rev_exec_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("fwd_exec_s", "rev_exec_s"))
