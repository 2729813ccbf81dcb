# Copied verbatim from svjedi_tpu/io/gfa.py.
"""Minimal GFA reading (for interop and debugging).

The pipeline itself builds graphs in memory (graph/build.py) and only writes
GFA; reading exists so the filter/genotype stages can run against an
externally produced graph + minigraph GAF, mirroring the reference's
file-glued staging (SURVEY §1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class GFA:
    #: node name -> sequence
    segments: Dict[str, str] = field(default_factory=dict)
    #: (name1, strand1, name2, strand2)
    links: List[Tuple[str, str, str, str]] = field(default_factory=list)
    #: path name -> ([node names], [strands])
    paths: Dict[str, Tuple[List[str], List[str]]] = field(default_factory=dict)
    comments: List[str] = field(default_factory=list)


def is_alt_node(name: str) -> bool:
    """Alt (INS) node names carry a '.' in the coordinate part.

    Reference heuristic: filter-alignments.py:109 (``"." in id.split(":")[-1]``).
    """
    return "." in name.split(":")[-1]


def read_gfa(path) -> GFA:
    gfa = GFA()
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                gfa.comments.append(line.rstrip("\n"))
                continue
            fields = line.rstrip("\n").split("\t")
            if fields[0] == "S":
                gfa.segments[fields[1]] = fields[2] if len(fields) > 2 else ""
            elif fields[0] == "L":
                gfa.links.append((fields[1], fields[2], fields[3], fields[4]))
            elif fields[0] == "P":
                names, strands = [], []
                for item in fields[2].split(","):
                    names.append(item[:-1])
                    strands.append(item[-1])
                gfa.paths[fields[1]] = (names, strands)
    return gfa


def alt_node_lengths(path) -> Dict[str, int]:
    """Lengths of alt (INS) nodes from a GFA (filter-alignments.py:103-113)."""
    out: Dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("S"):
                fields = line.rstrip("\n").split("\t")
                if is_alt_node(fields[1]):
                    out[fields[1]] = len(fields[2])
    return out
