"""Layer ``align.pipeline.compute_winner_stats`` audit; unit ms; moves
genotype_mbases_per_s. The audit's host piece assembly
(``timings["audit_assembly_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("audit_assembly_s"))
