"""Layer ``align.pipeline`` chunk loop; unit ms; moves
genotype_mbases_per_s. The program's span ``align.prune``:
``prune_secondaries`` and ``cross_cluster_prune`` inside ``count_s``
(``timings["prune_s"]``), per job."""

from benchmark.readers import per_job_ms, timing


def read(ctx):
    return per_job_ms(ctx, timing("prune_s"))
