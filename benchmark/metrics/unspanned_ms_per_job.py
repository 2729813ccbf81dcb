"""Layer whole job; unit ms; moves genotype_mbases_per_s. What no span
covers: each job's seconds less the harness's genotyping span
(``genotype_s``) and the program's twelve top-level spans of the calling
thread, which do not nest in one another (``timings`` keys):
``merge_index_s``, ``pull_s``, ``upload_s``, ``scan_dispatch_s``,
``seed_s``, ``dp_s``, ``fwd_exec_s``, ``rev_disp_s``, ``rev_exec_s``,
``count_s``, ``trim_s`` and ``merge_winners_s``; per job."""

from benchmark.readers import per_job_ms, timing

TOP_LEVEL = ("merge_index_s", "pull_s", "upload_s", "scan_dispatch_s",
             "seed_s", "dp_s", "fwd_exec_s", "rev_disp_s", "rev_exec_s",
             "count_s", "trim_s", "merge_winners_s")


def read(ctx):
    spanned = timing(*TOP_LEVEL)

    def rest(job):
        covered = spanned(job)
        return None if covered is None else (
            job.seconds - job.genotype_s - covered)

    return per_job_ms(ctx, rest)
