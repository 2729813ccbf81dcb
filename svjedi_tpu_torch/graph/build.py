# Copied verbatim from svjedi_tpu/graph/build.py.
"""Variation-graph construction: reference semantics, array-friendly core.

Reproduces the graph defined by construct-graph.py:283-554 (SURVEY §3.2):
per-chromosome reference segment nodes split at SV breakpoints, one path per
chromosome, and alt-allele links/nodes per SV type, with every breakpoint
junction tagged by the (sv, allele) pairs it supports. The in-memory form is
index-based (ints, not strings) so downstream stages are vectorizable; the
GFA / svs_edges.json exports are byte-identical to the reference's outputs on
inputs the reference handles without crashing.

Divergences (all are reference crash paths, documented in ARCHITECTURE.md):
- A chromosome with no breakpoints becomes a single node with no trailing
  empty node (reference emits an empty S line then raises KeyError,
  construct-graph.py:315-367).
- A DEL/INS whose flanking node is missing is warned+skipped instead of
  raising TypeError (reference: "None" joined into the L line, :416-449).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .svparse import ParsedVCF, parse_bnd_id

FWD = 0
REV = 1
_STRAND_CH = {FWD: "+", REV: "-"}


@dataclass
class Node:
    name: str  # printed GFA id, e.g. "1:10001-10500" or "1:72401.1"
    chrom: str
    start0: int  # 0-based inclusive (ref nodes); ins point for alt nodes
    end0: int  # 0-based inclusive; == start0-1 + len for alt nodes
    is_alt: bool
    length: int
    alt_seq: str = ""  # insert sequence (alt nodes only)


@dataclass
class Link:
    u: int  # from-node index
    su: int  # from strand (FWD/REV)
    v: int  # to-node index
    sv: int  # to strand
    #: (lookup_tag, allele) pairs; lookup_tag == "{chrom}:{sv_id}" exactly as
    #: predict-genotype queries it (chrom-prefix asymmetry included).
    tags: List[Tuple[str, int]] = field(default_factory=list)


@dataclass
class VariationGraph:
    chrom_order: List[str]
    chrom_seq: Dict[str, str]
    nodes: List[Node]
    links: List[Link]
    #: chrom -> node indices of its reference path, in order.
    chrom_path: Dict[str, List[int]]
    #: printed node name -> node index.
    node_by_name: Dict[str, int]
    #: GFA link-key ("n1@s1@n2@s2") -> [(tag, allele), ...] (svs_edges dict).
    link_tags: Dict[str, List[Tuple[str, int]]]
    #: chrom -> sv_id list (d_svs; '#' comment lines + alt emission order).
    chrom_svs: Dict[str, List[str]]
    parsed: ParsedVCF

    def node_seq(self, idx: int) -> str:
        n = self.nodes[idx]
        if n.is_alt:
            return n.alt_seq
        return self.chrom_seq[n.chrom][n.start0 : n.end0 + 1]

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)


def link_key(name1: str, s1: int, name2: str, s2: int) -> str:
    return "@".join([name1, _STRAND_CH[s1], name2, _STRAND_CH[s2]])


def _format_node_name(chrom: str, start0: int, end0: int) -> str:
    # 1-based printed coordinates (construct-graph.py:578-580).
    return f"{chrom}:{start0 + 1}-{end0 + 1}"


def _format_altnode_name(chrom: str, coord1: int, count: str) -> str:
    return f"{chrom}:{coord1}.{count}"


def build_graph(
    chrom_seq: Dict[str, str], parsed: ParsedVCF, warnings: Optional[list] = None
) -> VariationGraph:
    """Build the variation graph from parsed SVs.

    ``warnings`` (if given) collects the reference's warning strings
    (missing-node lookups etc.) for observability.
    """
    warnings = warnings if warnings is not None else []
    nodes: List[Node] = []
    links: List[Link] = []
    node_by_name: Dict[str, int] = {}
    chrom_path: Dict[str, List[int]] = {}
    link_tags: Dict[str, List[Tuple[str, int]]] = {}
    # Fast per-chrom lookup: printed start -> node idx, printed end -> idx.
    by_start: Dict[str, Dict[int, int]] = {}
    by_end: Dict[str, Dict[int, int]] = {}
    link_index: Dict[Tuple[int, int, int, int], int] = {}

    def add_node(node: Node) -> int:
        idx = len(nodes)
        nodes.append(node)
        node_by_name[node.name] = idx
        return idx

    def add_link(u: int, su: int, v: int, sv: int) -> Link:
        # Duplicate alt links append tags to the same Link (mirroring the
        # reference's d_link_sv append under one key) but each GFA L line is
        # still emitted per occurrence via the export's emission log below.
        key = (u, su, v, sv)
        if key in link_index:
            return links[link_index[key]]
        link = Link(u, su, v, sv)
        link_index[key] = len(links)
        links.append(link)
        return link

    # ------------------------------------------------------------------
    # Reference nodes, reference links (+ allele-0 tags), per-chrom paths.
    # construct-graph.py:293-377.
    # ------------------------------------------------------------------
    for chrom in chrom_seq:
        clen = len(chrom_seq[chrom])
        breakpoints = parsed.chr_bkpt.get(chrom, [])
        boundaries = [0] + list(breakpoints) + [clen]
        path: List[int] = []
        for i in range(len(boundaries) - 1):
            start0, end0 = boundaries[i], boundaries[i + 1] - 1
            idx = add_node(
                Node(
                    name=_format_node_name(chrom, start0, end0),
                    chrom=chrom,
                    start0=start0,
                    end0=end0,
                    is_alt=False,
                    length=end0 - start0 + 1,
                )
            )
            by_start.setdefault(chrom, {})[start0 + 1] = idx
            by_end.setdefault(chrom, {})[end0 + 1] = idx
            if path:
                link = add_link(path[-1], FWD, idx, FWD)
                # Tag with every SV owning this breakpoint, allele 0, with
                # the *processed* chromosome prefix (construct-graph.py:367;
                # this is the BND chrom-prefix asymmetry, SURVEY §3.2).
                bkpt = boundaries[i]
                for sv_id in parsed.bkpt_sv.get(chrom, {}).get(bkpt, []):
                    link.tags.append((f"{chrom}:{sv_id}", 0))
                key = link_key(nodes[path[-1]].name, FWD, nodes[idx].name, FWD)
                link_tags[key] = list(link.tags)  # ref phase overwrites (:364)
            path.append(idx)
        chrom_path[chrom] = path

    # Export log of alt-phase GFA lines, in reference emission order.
    alt_gfa_lines: List[str] = []

    def emit_link_line(n1: int, s1: int, n2: int, s2: int) -> None:
        alt_gfa_lines.append(
            "\t".join(
                ["L", nodes[n1].name, _STRAND_CH[s1], nodes[n2].name, _STRAND_CH[s2], "0M"]
            )
            + "\n"
        )

    def tag_alt(link: Link, tag: str) -> None:
        link.tags.append((tag, 1))
        key = link_key(
            nodes[link.u].name, link.su, nodes[link.v].name, link.sv
        )
        link_tags.setdefault(key, []).append((tag, 1))

    # ------------------------------------------------------------------
    # Alt nodes and alt links, per chrom / per SV in VCF order.
    # construct-graph.py:383-547. Details re-derived from the sv_id string,
    # exactly as the reference does (duplicate ids repeat their effects).
    # ------------------------------------------------------------------
    ins_seqs = {
        rec.sv_id: rec.ins_seq for rec in parsed.svs if rec.svtype == "INS"
    }

    for chrom, sv_list in parsed.chrom_svs.items():
        for sv_id in sv_list:
            sv_type = sv_id.split("-")[0]
            tag = f"{chrom}:{sv_id}"

            if sv_type == "DEL":
                pos_s, end_s = sv_id.split("-")[1:]
                pos, end = int(pos_s), int(end_s)
                left = by_end.get(chrom, {}).get(pos)
                right = by_start.get(chrom, {}).get(end + 1)
                if left is None or right is None:
                    warnings.append(f"missing flanking node for {sv_id} on {chrom}")
                    continue
                emit_link_line(left, FWD, right, FWD)
                tag_alt(add_link(left, FWD, right, FWD), tag)

            elif sv_type == "INS":
                pos_s, count_s = sv_id.split("-")[1:]
                pos = int(pos_s)
                seq = ins_seqs.get(sv_id, "")
                name = _format_altnode_name(chrom, pos + 1, count_s)
                if name in node_by_name:
                    ins_node = node_by_name[name]  # duplicate record
                else:
                    ins_node = add_node(
                        Node(
                            name=name,
                            chrom=chrom,
                            start0=pos,
                            end0=pos + len(seq) - 1,
                            is_alt=True,
                            length=len(seq),
                            alt_seq=seq,
                        )
                    )
                alt_gfa_lines.append("\t".join(["S", name, seq]) + "\n")
                left = by_end.get(chrom, {}).get(pos)
                right = by_start.get(chrom, {}).get(pos + 1)
                if left is None or right is None:
                    warnings.append(f"missing flanking node for {sv_id} on {chrom}")
                    continue
                emit_link_line(left, FWD, ins_node, FWD)
                emit_link_line(ins_node, FWD, right, FWD)
                tag_alt(add_link(left, FWD, ins_node, FWD), tag)
                tag_alt(add_link(ins_node, FWD, right, FWD), tag)

            elif sv_type == "INV":
                pos_s, end_s = sv_id.split("-")[1:]
                pos, end = int(pos_s), int(end_s)
                left = by_end.get(chrom, {}).get(pos)
                right = by_start.get(chrom, {}).get(end + 1)
                left_inv = by_start.get(chrom, {}).get(pos + 1)
                right_inv = by_end.get(chrom, {}).get(end)
                if None in (left, right, left_inv, right_inv):
                    # Silent skip, matching construct-graph.py:480-482.
                    continue
                emit_link_line(left, FWD, right_inv, REV)
                emit_link_line(left_inv, REV, right, FWD)
                tag_alt(add_link(left, FWD, right_inv, REV), tag)
                tag_alt(add_link(left_inv, REV, right, FWD), tag)

            elif sv_type == "BND":
                # Raw (uncorrected) endpoint lookup: construct-graph.py:506-521.
                left_c, right_c = parse_bnd_id(chrom, sv_id)
                if left_c is None:
                    continue
                lchrom, lpos, lstrand = left_c
                rchrom, rpos, rstrand = right_c
                if lstrand == "-":
                    left = by_start.get(lchrom, {}).get(lpos)
                else:
                    left = by_end.get(lchrom, {}).get(lpos)
                if rstrand == "+":
                    right = by_start.get(rchrom, {}).get(rpos)
                else:
                    right = by_end.get(rchrom, {}).get(rpos)
                if left is None or right is None:
                    warnings.append(
                        f"Warning: no alternative link defined for {sv_id}"
                    )
                    continue
                if lstrand == "-":
                    s1, s2 = REV, FWD
                elif rstrand == "-":
                    s1, s2 = FWD, REV
                else:
                    s1, s2 = FWD, FWD
                emit_link_line(left, s1, right, s2)
                tag_alt(add_link(left, s1, right, s2), tag)

    graph = VariationGraph(
        chrom_order=list(chrom_seq.keys()),
        chrom_seq=chrom_seq,
        nodes=nodes,
        links=links,
        chrom_path=chrom_path,
        node_by_name=node_by_name,
        link_tags=link_tags,
        chrom_svs=parsed.chrom_svs,
        parsed=parsed,
    )
    graph._alt_gfa_lines = alt_gfa_lines  # emission log for byte-parity export
    return graph


# ----------------------------------------------------------------------
# Exports (byte parity with construct-graph.py outputs).
# ----------------------------------------------------------------------


def write_gfa(graph: VariationGraph, path) -> None:
    """Write the GFA byte-identically to construct-graph.py:286-549."""
    with open(path, "w") as fh:
        for chrom in graph.chrom_order:
            svs = graph.chrom_svs.get(chrom, [])
            if svs:
                fh.write("#{}\t{}\n".format(chrom, ";".join(svs)))
        for chrom in graph.chrom_order:
            path_nodes = graph.chrom_path[chrom]
            lens = []
            for i, idx in enumerate(path_nodes):
                node = graph.nodes[idx]
                fh.write("\t".join(["S", node.name, graph.node_seq(idx)]) + "\n")
                lens.append(str(node.length))
                if i > 0:
                    fh.write(
                        "\t".join(
                            ["L", graph.nodes[path_nodes[i - 1]].name, "+", node.name, "+", "0M"]
                        )
                        + "\n"
                    )
            names = "+,".join(graph.nodes[i].name for i in path_nodes) + "+"
            fh.write(
                "\t".join(["P", chrom, names, "M,".join(lens) + "M"]) + "\n"
            )
        for line in getattr(graph, "_alt_gfa_lines", []):
            fh.write(line)


def write_svs_edges_json(graph: VariationGraph, path) -> None:
    """Write svs_edges.json byte-identically (construct-graph.py:553-554)."""
    import json

    serializable = {
        k: [[t, a] for (t, a) in v] for k, v in graph.link_tags.items()
    }
    with open(path, "w") as fh:
        fh.write(json.dumps(serializable, sort_keys=True, indent=4))


def write_ignored_svs(parsed: ParsedVCF, path) -> None:
    """Write the discarded-SV ledger (construct-graph.py:276-280)."""
    with open(path, "w") as fh:
        fh.write(
            "##The following SVs were ignored during graph construction due to wrong format"
        )
        for line in parsed.discarded:
            fh.write("\n" + line)
