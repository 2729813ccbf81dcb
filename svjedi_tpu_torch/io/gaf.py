# Copied verbatim from svjedi_tpu/io/gaf.py.
"""GAF parsing/writing (graph-alignment format, minigraph's output).

Field semantics follow what the reference consumes (filter-alignments.py:
184-198): columns 1-4 query id/len/start/end, 6-9 path/pathlen/start/end,
10-12 matches/block-length/mapq, optional ``id:f:`` identity tag.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Tuple


@dataclass
class GAFRecord:
    qid: str
    qlen: int
    qstart: int
    qend: int
    strand: str
    path: str  # e.g. ">1:1-10000>1:10001-10500"
    plen: int
    pstart: int
    pend: int
    matches: int
    block_len: int
    mapq: int
    identity: float
    line: str  # raw line (rstripped)

    def path_nodes(self) -> List[str]:
        """Node names in path order (filter-alignments.py:351-373)."""
        return [s for s in re.split(r"[<>]", self.path) if s]

    def path_links(self) -> List[Tuple[str, str, str, str]]:
        """Oriented links crossed by the path (filter-alignments.py:200-219)."""
        nodes = self.path_nodes()
        strands = []
        for node in nodes:
            prefix = self.path.split(node)[0]
            strands.append("+" if prefix[-1] == ">" else "-")
        return [
            (nodes[i - 1], strands[i - 1], nodes[i], strands[i])
            for i in range(1, len(nodes))
        ]


def parse_gaf_line(line: str) -> GAFRecord:
    fields = line.rstrip("\n").split("\t")
    identity = None
    if "id:f:" in line:
        identity = float(line.split("id:f:")[-1].split("\t")[0])
    matches, block_len = int(fields[9]), int(fields[10])
    if identity is None:
        identity = matches / block_len if block_len else 0.0
    return GAFRecord(
        qid=fields[0],
        qlen=int(fields[1]),
        qstart=int(fields[2]),
        qend=int(fields[3]),
        strand=fields[4],
        path=fields[5],
        plen=int(fields[6]),
        pstart=int(fields[7]),
        pend=int(fields[8]),
        matches=matches,
        block_len=block_len,
        mapq=int(fields[11]),
        identity=identity,
        line=line.rstrip("\n"),
    )


def read_gaf(path) -> Iterator[GAFRecord]:
    with open(path) as fh:
        for line in fh:
            if line.strip():
                yield parse_gaf_line(line)


def reverse_link(link: Tuple[str, str, str, str]) -> Tuple[str, str, str, str]:
    """Reverse-complement of an oriented link (filter-alignments.py:221-225)."""
    flip = {"+": "-", "-": "+"}
    return (link[2], flip[link[3]], link[0], flip[link[1]])


def format_gaf_line(
    qid: str, qlen: int, qstart: int, qend: int, strand: str, path: str,
    plen: int, pstart: int, pend: int, matches: int, block_len: int,
    mapq: int, identity: float,
) -> str:
    return "\t".join(
        [
            qid, str(qlen), str(qstart), str(qend), strand, path,
            str(plen), str(pstart), str(pend), str(matches),
            str(block_len), str(mapq), f"id:f:{identity:.6f}",
        ]
    )
