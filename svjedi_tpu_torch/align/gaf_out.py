# Copied verbatim from svjedi_tpu/align/gaf_out.py.
"""GAF emission for winning alignments (interop / debugging).

Produces minigraph-style GAF records from panel-path alignments: the path
column lists the walk's oriented nodes, path coordinates are in full-walk
space (trim offsets re-applied), and identity is estimated from the DP
score.

Caveat for anyone feeding this back through the GAF filter: these records
are per-(read, cluster) local alignments, so a read spanning two clusters
yields two records whose flanks overlap. The native counter only counts
each cluster's own links (so overlap cannot double count); a naive GAF
re-filter counts every tagged link per record and would double count the
overlap region. Use the GAF for inspection and interop debugging, not as a
substitute counting path.
"""

from __future__ import annotations

from typing import Iterator

from ..graph.build import REV
from ..graph.cluster import Panel
from ..io.fastq import ReadSet
from ..io.gaf import format_gaf_line


def winners_to_gaf(
    panel: Panel, winners, reads: ReadSet, params=None
) -> Iterator[str]:
    """Yield one GAF line per winning alignment."""
    graph = panel.graph
    lengths = reads.lengths  # property: materialize once, not per winner
    for i in range(len(winners.read)):
        path = panel.paths[int(winners.path[i])]
        read_id = int(winners.read[i])
        rlen = int(lengths[read_id])
        strand = int(winners.strand[i])
        qs, qe = int(winners.qs[i]), int(winners.qe[i])
        if strand:
            # Spans are in the oriented (reverse-complemented) read; report
            # forward-read coordinates like minigraph does.
            qs, qe = rlen - 1 - qe, rlen - 1 - qs
        path_str = "".join(
            ("<" if s == REV else ">") + graph.nodes[n].name
            for (n, s) in path.states
        )
        ts_full = int(winners.ts[i]) + path.trim_left
        te_full = int(winners.te[i]) + path.trim_left
        block = max(te_full - ts_full + 1, 1)
        score = int(winners.score[i])
        match_score = params.match if params is not None else 2
        matches = min(block, max(0, score // match_score))
        yield format_gaf_line(
            qid=reads.names[read_id],
            qlen=rlen,
            qstart=qs,
            qend=qe + 1,
            strand="+-"[strand],
            path=path_str,
            plen=path.full_len,
            pstart=ts_full,
            pend=te_full + 1,
            matches=matches,
            block_len=block,
            mapq=(
                int(winners.mapq[i]) if winners.mapq is not None else 60
            ),
            identity=matches / block,
        )


def write_gaf(path, panel: Panel, winners, reads: ReadSet, params=None) -> None:
    with open(path, "w") as fh:
        for line in winners_to_gaf(panel, winners, reads, params):
            fh.write(line + "\n")
