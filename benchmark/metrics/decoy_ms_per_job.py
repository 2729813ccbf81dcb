"""Layer ``align.seed`` and ``align.decoy`` host seeding; unit ms; moves
genotype_mbases_per_s. The program's span ``align.seed.decoy``: the seeder
thread's decoy suppression, inside ``align.seed`` (``timings["decoy_s"]``),
per job. A program without the span reads nothing."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("decoy_s"))
