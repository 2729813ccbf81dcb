# Copied verbatim from svjedi_tpu/genotype/filter_gaf.py.
"""Informative-alignment filtering from a GAF (interop path).

Replicates filter-alignments.py:90-175 semantics so the genotype stages can
consume an externally produced (e.g. minigraph) GAF against our graph:
per record, decompose the alignment path into oriented links, probe the
edge→SV map with each link and its reverse-complement, and keep alignments
passing the breakpoint-overlap rule (≥ d_over aligned bases on each side of
the crossed junction, measured in path space).

The native pipeline does not go through GAF at all — it counts directly from
panel alignments (align/pipeline.py) — but both paths share
:func:`check_bkpt_overlap` and produce the same audit JSON schema.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple

from ..io.gaf import GAFRecord, read_gaf, reverse_link
from ..io.gfa import alt_node_lengths, is_alt_node


def node_length(name: str, alt_len: Dict[str, int]) -> int:
    """Node length from its id coords, or the GFA for alt nodes
    (filter-alignments.py:343-349)."""
    if is_alt_node(name):
        return alt_len[name]
    start, end = name.split(":")[-1].split("-")
    return int(end) - int(start) + 1


def check_bkpt_overlap(
    link: Tuple[str, str, str, str],
    path_nodes: Sequence[str],
    d_over: int,
    pstart: int,
    plen: int,
    pend: int,
    alt_len: Dict[str, int],
) -> bool:
    """Breakpoint-overlap rule (filter-alignments.py:258-273).

    left:  sum(node lens from path start through the link's left node) - Ts
    right: sum(node lens from the link's right node to path end) - (Tlen-Te-1)
    both must be >= d_over. Uses ``list.index`` like the reference (first
    occurrence wins if a node repeats in the path).
    """
    unaligned_start = pstart
    unaligned_end = plen - pend - 1
    nodes = list(path_nodes)
    left_idx = nodes.index(link[0])
    right_idx = nodes.index(link[2])
    left_span = (
        sum(node_length(n, alt_len) for n in nodes[: left_idx + 1])
        - unaligned_start
    )
    right_span = (
        sum(node_length(n, alt_len) for n in nodes[right_idx:]) - unaligned_end
    )
    return left_span >= d_over and right_span >= d_over


def filter_gaf_records(
    records: Iterable[GAFRecord],
    link_tags: Dict[str, List],
    alt_len: Dict[str, int],
    d_over: int = 100,
) -> Dict[str, List[List[str]]]:
    """Build the informative-alignment table from GAF records.

    Returns ``{lookup_key: [[ref alignment lines], [alt alignment lines]]}``
    with lines truncated before ``cg:Z:`` (filter-alignments.py:166).
    """
    informative: Dict[str, List[List[str]]] = {}
    for rec in records:
        nodes = rec.path_nodes()
        if len(nodes) < 2:
            continue
        for link in rec.path_links():
            keys = []
            for key in ("@".join(link), "@".join(reverse_link(link))):
                if key in link_tags:
                    keys.append(key)
            for key in keys:
                for sv_tag, allele in link_tags[key]:
                    if check_bkpt_overlap(
                        link, nodes, d_over, rec.pstart, rec.plen, rec.pend, alt_len
                    ):
                        entry = informative.setdefault(sv_tag, [[], []])
                        entry[allele].append(rec.line.split("cg:Z:")[0])
    return informative


def filter_gaf_files(
    gaf_path, gfa_path, svs_edges_json, d_over: int = 100
) -> Dict[str, List[List[str]]]:
    """File-level interop entry: GAF + GFA + svs_edges.json → table."""
    with open(svs_edges_json) as fh:
        link_tags = json.load(fh)
    alt_len = alt_node_lengths(gfa_path)
    return filter_gaf_records(read_gaf(gaf_path), link_tags, alt_len, d_over)


def write_informative_json(informative: Dict, path) -> None:
    """Audit JSON, same schema/formatting as filter-alignments.py:174-175."""
    with open(path, "w") as fh:
        fh.write(json.dumps(informative, sort_keys=True, indent=4))


def counts_from_informative(informative: Dict) -> Dict[str, List[int]]:
    """Collapse the audit table to per-SV [ref, alt] counts
    (predict-genotype.py:219-226)."""
    return {
        key: [len(entry[0]), len(entry[1])] for key, entry in informative.items()
    }
