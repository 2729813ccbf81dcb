"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. The program's span ``align.finalize``:
``finalize_chunk``, the winner election inside ``rev_disp_s``
(``timings["finalize_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("finalize_s"))
