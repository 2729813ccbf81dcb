"""Layer ``align.seed`` and ``align.decoy`` host seeding; unit ms; moves
genotype_mbases_per_s. The program's span ``align.seed.scan_wait`` on
the seeder thread: the wait for the device scan's bitmask
(``timings["scan_wait_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("scan_wait_s"))
