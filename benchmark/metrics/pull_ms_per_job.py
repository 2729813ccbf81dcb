"""Layer ``io.fastq`` read stream; unit ms; moves genotype_mbases_per_s.
The program's span ``align.pull``: each ``next()`` of the chunk
iterator, the stream's pull seen from inside the chunk loop
(``timings["pull_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("pull_s"))
