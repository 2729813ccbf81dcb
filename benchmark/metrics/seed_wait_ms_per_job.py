"""Layer ``align.seed`` / ``align.decoy`` host seeding; unit ms; moves
genotype_mbases_per_s. The chunk loop's exposed wait on the seeder thread
(``timings["seed_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("seed_s"))
