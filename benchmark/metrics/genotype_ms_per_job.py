"""Layer ``genotype``; unit ms; moves genotype_mbases_per_s. The harness's
span around ``write_genotyped_vcf``, per job."""

from benchmark.readers import per_job_ms


def read(ctx):
    return per_job_ms(ctx, lambda job: job.genotype_s)
