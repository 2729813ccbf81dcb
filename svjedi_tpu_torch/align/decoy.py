# Copied verbatim from svjedi_tpu/align/decoy.py.
"""Genome-wide decoy competition (specificity).

minigraph maps every read against the WHOLE graph (svjedi-graph.py:104), so
a read from a repeat or paralog loses to its true locus and never reaches
the allele filter as a spurious panel hit. The panel aligner sees only
breakpoint neighborhoods, so repetitive reads can manufacture false allele
support. This module restores whole-genome competition at chain level, the
same stage where minigraph's primary/secondary selection happens (chain
score, before base alignment):

1. a minimizer index over the reference chromosomes (one "path" per chrom)
   is built once;
2. every read chunk is seeded+chained against it with the same native
   chainer as the panel;
3. a panel chain is SUPPRESSED (all its blocks dropped before DP) when a
   decoy chain of the same read (a) covers >= ``overlap_frac`` of the panel
   chain's read interval, (b) lies genomically OUTSIDE the panel cluster's
   span (a same-locus decoy is the ref allele, not a competitor), and
   (c) carries strictly more anchors.

Suppression is pre-DP, so the specificity fix also removes junk DP volume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..graph.cluster import Panel
from ..io.fastq import ReadSet, encode_ascii
from .index import PanelIndex
from .minimizer import extract_minimizers
from .seed import Candidates, ChainParams, seed_candidates


@dataclass
class Decoy:
    """Decoy index + panel-cluster genomic spans + knobs."""

    index: PanelIndex  # over chromosomes (path id = chrom order index)
    chrom_of_path: List[str]
    #: cluster id -> {chrom: (lo, hi)} genomic span of its panel paths
    cluster_spans: List[Dict[str, Tuple[int, int]]]
    overlap_frac: float = 0.5
    margin: int = 500
    #: dense (n_clusters, n_chroms) copies of ``cluster_spans`` for the
    #: vectorized suppression (lo > hi encodes "no span on this chrom")
    span_lo: np.ndarray = None
    span_hi: np.ndarray = None

    def __post_init__(self):
        if self.span_lo is None:
            n_chroms = len(self.chrom_of_path)
            cid = {c: i for i, c in enumerate(self.chrom_of_path)}
            n_cl = len(self.cluster_spans)
            self.span_lo = np.full((n_cl, n_chroms), 1 << 62, dtype=np.int64)
            self.span_hi = np.full((n_cl, n_chroms), -(1 << 62), dtype=np.int64)
            for ci, span in enumerate(self.cluster_spans):
                for chrom, (lo, hi) in span.items():
                    self.span_lo[ci, cid[chrom]] = lo
                    self.span_hi[ci, cid[chrom]] = hi


def build_decoy(
    panel: Panel, k: int, w: int, max_hits_per_minimizer: int = 64
) -> Decoy:
    """Build the whole-genome decoy index + per-cluster genomic spans."""
    graph = panel.graph
    hashes, paths, positions, strands = [], [], [], []
    chrom_of_path = list(graph.chrom_order)
    lens = []
    for pid, chrom in enumerate(chrom_of_path):
        codes = encode_ascii(graph.chrom_seq[chrom])
        lens.append(len(codes))
        mins = extract_minimizers(codes, k, w)
        hashes.append(mins.hash)
        positions.append(mins.pos)
        strands.append(mins.strand)
        paths.append(np.full(len(mins.pos), pid, dtype=np.int32))

    all_hash = np.concatenate(hashes) if hashes else np.zeros(0, np.uint32)
    all_path = np.concatenate(paths) if paths else np.zeros(0, np.int32)
    all_pos = np.concatenate(positions) if positions else np.zeros(0, np.int32)
    all_strand = np.concatenate(strands) if strands else np.zeros(0, np.int8)
    order = np.argsort(all_hash, kind="stable")
    all_hash, all_path = all_hash[order], all_path[order]
    all_pos, all_strand = all_pos[order], all_strand[order]
    uniq, start = np.unique(all_hash, return_index=True)
    counts = np.diff(np.append(start, len(all_hash)))
    keep = counts <= max_hits_per_minimizer
    # Vectorized kept-row mask (hits per hash are contiguous); see the
    # matching note in index.build_panel_index — the per-hash np.arange
    # form was the decoy-build memory/time transient at Gb scale.
    sel = np.repeat(keep, counts)
    uniq = uniq[keep]
    hit_start = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(counts[keep], out=hit_start[1:])
    n_paths = len(chrom_of_path)
    index = PanelIndex(
        k=k,
        w=w,
        uniq_hash=uniq,
        hit_start=hit_start,
        hit_path=all_path[sel],
        hit_pos=all_pos[sel],
        hit_strand=all_strand[sel],
        path_cluster=np.arange(n_paths, dtype=np.int32),
        path_len=np.array(lens, dtype=np.int32),
        path_first_j=np.zeros(n_paths, dtype=np.int32),
        path_last_j=np.zeros(n_paths, dtype=np.int32),
    )

    # Genomic span per cluster from the TRIMMED path sequences: panel paths
    # keep only ``flank`` bases beyond the outer junctions, so a full-node
    # span (nodes can be tens of kb) would classify far-away decoy hits as
    # "same locus" and defeat the suppression.
    spans: List[Dict[str, Tuple[int, int]]] = []
    for cl in panel.clusters:
        span: Dict[str, Tuple[int, int]] = {}

        def widen(chrom: str, lo: int, hi: int) -> None:
            if chrom in span:
                a, b = span[chrom]
                span[chrom] = (min(a, lo), max(b, hi))
            else:
                span[chrom] = (lo, hi)

        for pi in cl.paths:
            p = panel.paths[pi]
            trim_lo = p.trim_left
            trim_hi = p.trim_left + p.length
            off = 0
            for node_idx, strand in p.states:
                node = graph.nodes[node_idx]
                nlen = node.length
                a = max(trim_lo, off) - off
                b = min(trim_hi, off + nlen) - off
                if b > a:
                    if node.is_alt:  # INS node: a point at the insert site
                        widen(node.chrom, node.start0, node.end0)
                    elif strand == 0:  # FWD
                        widen(node.chrom, node.start0 + a, node.start0 + b - 1)
                    else:
                        widen(node.chrom, node.end0 - (b - 1), node.end0 - a)
                off += nlen
        spans.append(span)
    return Decoy(index=index, chrom_of_path=chrom_of_path, cluster_spans=spans)


def _chain_table(cands: Candidates, rlen: np.ndarray):
    """Aggregate block rows into per-chain rows.

    Returns (chain_ids, read, path, strand, support, q_lo_f, q_hi_f, t_lo,
    t_hi): the ANCHOR-extent read interval normalized to FORWARD read
    coordinates and the corresponding genomic (path) interval."""
    if len(cands) == 0:
        z = np.zeros(0, np.int64)
        return (z,) * 9
    uniq, first = np.unique(cands.chain, return_index=True)
    # blocks of one chain are contiguous; last row index per chain:
    order = np.argsort(cands.chain, kind="stable")
    last = np.zeros(len(uniq), dtype=np.int64)
    np.maximum.at(
        last,
        np.searchsorted(uniq, cands.chain[order]),
        order,
    )
    read = cands.read[first].astype(np.int64)
    path = cands.path[first].astype(np.int64)
    strand = cands.strand[first].astype(np.int64)
    support = cands.n_anchors[first].astype(np.int64)
    a_lo = cands.a_lo[first].astype(np.int64)
    a_hi = cands.a_hi[first].astype(np.int64)
    rl = rlen[read]
    q_lo_f = np.where(strand == 0, a_lo, rl - a_hi)
    q_hi_f = np.where(strand == 0, a_hi, rl - a_lo)
    t_lo = cands.d0[first].astype(np.int64) + a_lo
    t_hi = cands.d0[last].astype(np.int64) + a_hi
    return uniq, read, path, strand, support, q_lo_f, q_hi_f, t_lo, t_hi


def suppress_candidates(
    reads: ReadSet,
    cands: Candidates,
    index: PanelIndex,
    decoy: Decoy,
    chain_params: ChainParams,
    threads: int = 0,
    dec: Candidates = None,
    return_margins: bool = False,
) -> np.ndarray:
    """Return a keep-mask over ``cands`` rows (False = suppressed chain).

    With ``return_margins``, returns (keep, dec_other, dec_same): per-ROW
    copies of the chain's strongest elsewhere / at-locus decoy anchor
    supports — the evidence the mapq model turns into a confidence margin
    (a surviving chain with dec_other close to max(dec_same, own support)
    barely beat its best alternative placement).

    ``dec`` passes pre-seeded decoy chains in (the combined-index seeding
    path splits one scan into panel + decoy rows); when None the decoy
    index is seeded here.

    A panel chain survives when the read's best full-length explanation
    among the decoy chains covering its read interval lies AT the
    cluster's locus (the read belongs here — panel support is measured
    on a trimmed window, so it must not compete with full-length decoy
    chains directly), or when the panel chain itself out-anchors every
    elsewhere-decoy (novel-insertion content has no decoy at all).
    "At the locus" is judged on the decoy's genomic SUB-interval for the
    overlapping read bases (linear map along the chain): a long decoy
    chain merely touching the cluster span with its tip must not
    whitelist junk that maps those read bases elsewhere.
    """
    def ret(keep, chain_other=None, chain_same=None, p_chain=None):
        if not return_margins:
            return keep
        row_other = np.zeros(len(cands), dtype=np.int32)
        row_same = np.zeros(len(cands), dtype=np.int32)
        if chain_other is not None and len(p_chain):
            # p_chain is sorted (np.unique); map chain-level margins to rows
            ci = np.searchsorted(p_chain, cands.chain)
            ci = np.clip(ci, 0, len(p_chain) - 1)
            hit = p_chain[ci] == cands.chain
            row_other[hit] = chain_other[ci[hit]]
            row_same[hit] = chain_same[ci[hit]]
        return keep, row_other, row_same

    n = len(cands)
    if n == 0:
        return ret(np.ones(0, dtype=bool))
    if dec is None:
        dec = seed_candidates(
            reads, decoy.index, chain_params=chain_params, threads=threads
        )
    (d_chain, d_read, d_path, d_strand, d_sup, d_qlo, d_qhi, d_tlo, d_thi) = (
        _chain_table(dec, reads.lengths)
    )
    (p_chain, p_read, p_path, _p_str, p_sup, p_qlo, p_qhi, _, _) = (
        _chain_table(cands, reads.lengths)
    )
    if len(d_chain) == 0:
        return ret(np.ones(n, dtype=bool))
    p_cluster = index.path_cluster[p_path].astype(np.int64)

    # Hot path: the native threaded inner loop (fastio.cpp svt_suppress,
    # same semantics as the numpy pair path below, which stays as the
    # tested reference). Chain tables come out read-sorted (chain ids are
    # assigned in read order); the native call requires it.
    from ..utils.native import load_native

    native = load_native()
    if native is not None and hasattr(native._lib, "svt_suppress"):
        res = native.suppress(
            p_read, p_sup, p_qlo, p_qhi, p_cluster,
            d_read, d_path, d_strand, d_sup, d_qlo, d_qhi, d_tlo, d_thi,
            decoy.span_lo, decoy.span_hi, len(decoy.chrom_of_path),
            decoy.overlap_frac, decoy.margin, n_threads=threads,
            return_margins=return_margins,
        )
        if res is not None:
            if return_margins:
                suppressed_rows, c_other, c_same = res
                suppressed_rows = suppressed_rows.astype(bool)
                if suppressed_rows.any():
                    keep = ~np.isin(cands.chain, p_chain[suppressed_rows])
                else:
                    keep = np.ones(n, dtype=bool)
                return ret(keep, c_other, c_same, p_chain)
            suppressed_rows = res.astype(bool)
            if not suppressed_rows.any():
                return np.ones(n, dtype=bool)
            return ~np.isin(cands.chain, p_chain[suppressed_rows])

    # Expand (panel chain, same-read decoy chain) pairs; everything below
    # is vectorized over pairs (the per-chain Python loop cost ~1.3 ms per
    # read at test-dir scale — the whole align budget).
    d_order = np.argsort(d_read, kind="stable")
    d_read_s = d_read[d_order]
    lo = np.searchsorted(d_read_s, p_read, "left")
    hi = np.searchsorted(d_read_s, p_read, "right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return ret(np.ones(n, dtype=bool))
    prefix = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=prefix[1:])
    flat = np.arange(total, dtype=np.int64) - np.repeat(prefix, counts)
    pair_p = np.repeat(np.arange(len(p_chain), dtype=np.int64), counts)
    pair_d = d_order[np.repeat(lo, counts) + flat]

    plen = (p_qhi - p_qlo)[pair_p]
    ov_lo = np.maximum(p_qlo[pair_p], d_qlo[pair_d])
    ov_hi = np.minimum(p_qhi[pair_p], d_qhi[pair_d])
    covers = (plen > 0) & (ov_hi - ov_lo >= decoy.overlap_frac * plen)

    # Decoy genomic sub-interval for the overlapping read bases.
    fwd = d_strand[pair_d] == 0
    g1 = np.where(
        fwd,
        d_tlo[pair_d] + (ov_lo - d_qlo[pair_d]),
        d_thi[pair_d] - (ov_hi - d_qlo[pair_d]),
    )
    g2 = np.where(
        fwd,
        d_tlo[pair_d] + (ov_hi - d_qlo[pair_d]),
        d_thi[pair_d] - (ov_lo - d_qlo[pair_d]),
    )
    cl = p_cluster[pair_p]
    ch = d_path[pair_d]
    ex_lo = decoy.span_lo[cl, ch]
    ex_hi = decoy.span_hi[cl, ch]
    has_span = ex_lo <= ex_hi
    same = has_span & (g2 >= ex_lo - decoy.margin) & (g1 <= ex_hi + decoy.margin)

    sup = d_sup[pair_d]
    best_same = np.zeros(len(p_chain), dtype=np.int64)
    best_other = np.zeros(len(p_chain), dtype=np.int64)
    m_same = covers & same
    m_other = covers & ~same
    np.maximum.at(best_same, pair_p[m_same], sup[m_same])
    np.maximum.at(best_other, pair_p[m_other], sup[m_other])

    suppressed_rows = best_other > np.maximum(best_same, p_sup)
    if suppressed_rows.any():
        keep = ~np.isin(cands.chain, p_chain[suppressed_rows])
    else:
        keep = np.ones(n, dtype=bool)
    return ret(
        keep,
        best_other.astype(np.int32),
        best_same.astype(np.int32),
        p_chain,
    )
