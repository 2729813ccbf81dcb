"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. The program's span ``align.count_support``:
``count_support`` inside ``count_s`` (``timings["count_support_s"]``),
per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("count_support_s"))
