"""Layer ``align.seed`` and ``align.decoy`` host seeding; unit ms; moves
genotype_mbases_per_s. The program's span ``align.merge_indexes``: the
panel and decoy indexes merged for seeding
(``timings["merge_index_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("merge_index_s"))
