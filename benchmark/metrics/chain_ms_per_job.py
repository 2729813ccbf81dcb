"""Layer ``align.seed`` and ``align.decoy`` host seeding; unit ms; moves
genotype_mbases_per_s. The program's span ``align.seed.chain``: the seeder
thread's minimizer lookup and chaining (``seed_candidates``), inside
``align.seed`` (``timings["chain_s"]``), per job. A program without the
span reads nothing."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("chain_s"))
