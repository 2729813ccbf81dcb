"""Layer ``align.pipeline.compute_winner_stats`` audit; unit ms; moves
genotype_mbases_per_s. The program's span ``align.audit.table``: the
audit's piece table and bucket pick, before its assembly
(``timings["audit_table_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("audit_table_s"))
