"""Layer ``align.seed`` and ``align.decoy`` host seeding; unit thousands;
moves genotype_mbases_per_s. The program's counter ``decoy_chains``: the
decoy-index candidate rows that compete in the decoy's suppression of a
chunk's panel candidates, per job. A program without the counter reads
nothing."""


def read(ctx):
    rows = [j.timings.get("decoy_chains") for j in ctx["jobs"]]
    if not rows or None in rows:
        return None
    return sum(rows) / len(rows) / 1e3
