# Copied verbatim from svjedi_tpu/io/fasta.py.
"""FASTA reading with the reference loader's exact semantics.

Reference behavior (construct-graph.py:79-96): whole-genome dict
``name -> uppercased sequence`` where the name is the first
whitespace-delimited token after ``>``. Order of first appearance is
preserved (it determines GFA emission order).
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, Union


def _open_text(path: Union[str, Path]):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: Union[str, Path]) -> Dict[str, str]:
    """Load a (possibly gzipped) FASTA into an ordered ``{name: seq}`` dict."""
    chroms: Dict[str, str] = {}
    name = None
    parts = []
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    chroms[name] = "".join(parts)
                name = line[1:].split()[0].rstrip("\n")
                parts = []
            else:
                parts.append(line.strip().upper())
    if name is not None:
        chroms[name] = "".join(parts)
    return chroms


def write_fasta(path: Union[str, Path], chroms: Dict[str, str], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in chroms.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
