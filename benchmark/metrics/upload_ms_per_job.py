"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. The program's span ``align.upload``: each chunk's
upload and 2-bit packing enqueued on the card (``timings["upload_s"]``),
per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("upload_s"))
