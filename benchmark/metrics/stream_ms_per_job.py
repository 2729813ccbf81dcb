"""Layer ``io.fastq`` read stream; unit ms; moves genotype_mbases_per_s.
Host time inside the stream's ``chunks()`` pulls, per job."""

from benchmark.readers import per_job_ms


def read(ctx):
    return per_job_ms(ctx, lambda job: job.stream_s)
