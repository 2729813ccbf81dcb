# Copied verbatim from svjedi_tpu/dist/decoy_shard.py.
"""Decoy-index sharding over the ``graph`` mesh axis (Gb-genome gate 2/2).

The whole-genome decoy competition (align/decoy.py) is the memory giant at
human scale: a 3 Gb genome is a ~550 M-hit table (~13 bytes/hit plus sort
scratch — the dominant term of the r4 250 GB Gb-RSS projection, PERF.md).
The reference never pays this because minigraph owns the whole-graph index
in its own C process (svjedi-graph.py:104); our equivalent is to partition
the decoy hit table by GENOMIC RANGE into G shards, one per ``graph``
mesh-axis rank:

- Each shard holds hits whose genomic position lies in its owned range
  widened by ``margin`` on both sides. ``margin`` exceeds the longest
  possible decoy chain span plus the chaining interaction radius (reads
  cap at 30,720 bases; chain_max_gap 4,096), so every decoy chain forms
  IDENTICALLY in the shard owning its genomic start — chaining is local:
  anchors farther than the drift tolerance can neither join nor displace
  a chain (fastio.cpp chain_one_read's greedy election).
- A chain is CLAIMED by exactly the shard whose owned range contains its
  genomic start; copies forming inside a neighbor's margin are dropped.
  The union of claimed chains over shards therefore equals the unsharded
  chain set exactly (tests/test_decoy_shard.py asserts byte equality).
- Suppression margins (best elsewhere / at-locus decoy support per panel
  chain, align/decoy.py suppress_candidates) are per-shard maxima; the
  global margins are the elementwise MAX over shards — an associative
  reduction that rides the same collective layer as the count psum (a
  max-allreduce on the graph axis; dist/multihost.allreduce_max_margins).

Hash-partitioning (the obvious alternative) is WRONG here: chains are
built from genomically co-located anchors, and splitting a chain's
anchors across shards by hash would fragment every chain.

Memory: per-shard hit-table residency is ~1/G of the full table (plus
2 x margin per boundary — negligible); ``build_decoy_shard`` constructs a
single shard without ever materializing the full sorted hit table (only
the per-chrom hash stream for the GLOBAL occurrence cap, which must be
computed genome-wide to match the unsharded index's repeat filter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..align.decoy import Decoy, _chain_table
from ..align.index import PanelIndex
from ..align.seed import Candidates, ChainParams, seed_candidates
from ..io.fastq import ReadSet, encode_ascii

#: Default shard overlap: > max read bucket (30,720) + chain drift +
#: chaining interaction radius (max_gap 4,096 + drift ~700), rounded up.
DEFAULT_MARGIN = 65536


@dataclass
class DecoyShard:
    """One graph-axis shard of the decoy competition."""

    decoy: Decoy  # part index (full chrom path list, hit subset)
    shard: int
    n_shards: int
    #: owned genomic range in concatenated-genome coordinates
    own_lo: int
    own_hi: int
    #: per-chrom offset into the concatenated coordinate
    chrom_offset: np.ndarray  # int64 (n_chroms,)

    @property
    def n_hits(self) -> int:
        return int(len(self.decoy.index.hit_path))

    def hit_bytes(self) -> int:
        """Resident bytes of this shard's hit table (the sharded term)."""
        idx = self.decoy.index
        return int(
            idx.uniq_hash.nbytes + idx.hit_start.nbytes + idx.hit_path.nbytes
            + idx.hit_pos.nbytes + idx.hit_strand.nbytes
        )


def _chrom_offsets(path_len: np.ndarray) -> np.ndarray:
    off = np.zeros(len(path_len) + 1, dtype=np.int64)
    np.cumsum(path_len.astype(np.int64), out=off[1:])
    return off


def _subset_index(idx: PanelIndex, sel: np.ndarray) -> PanelIndex:
    """Index over the hit subset ``sel`` (bool mask, hash order kept)."""
    counts_all = np.diff(idx.hit_start)
    hash_of_hit = np.repeat(np.arange(len(idx.uniq_hash)), counts_all)
    kept_hash = hash_of_hit[sel]
    uniq_ids, counts = np.unique(kept_hash, return_counts=True)
    hit_start = np.zeros(len(uniq_ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=hit_start[1:])
    return PanelIndex(
        k=idx.k,
        w=idx.w,
        uniq_hash=idx.uniq_hash[uniq_ids],
        hit_start=hit_start,
        hit_path=idx.hit_path[sel],
        hit_pos=idx.hit_pos[sel],
        hit_strand=idx.hit_strand[sel],
        path_cluster=idx.path_cluster,
        path_len=idx.path_len,
        path_first_j=idx.path_first_j,
        path_last_j=idx.path_last_j,
    )


def shard_bounds(total: int, n_shards: int, shard: int) -> Tuple[int, int]:
    return total * shard // n_shards, total * (shard + 1) // n_shards


def split_decoy(
    decoy: Decoy, n_shards: int, margin: int = DEFAULT_MARGIN
) -> List[DecoyShard]:
    """Split a built decoy into genomic-range shards (exact, in-memory).

    Used when the full index already exists (single-host sequential mode,
    tests); ``build_decoy_shard`` builds one shard from scratch without
    the full table for memory-bound multi-process runs.
    """
    idx = decoy.index
    off = _chrom_offsets(idx.path_len)
    total = int(off[-1])
    gpos = off[idx.hit_path] + idx.hit_pos.astype(np.int64)
    shards: List[DecoyShard] = []
    for s in range(n_shards):
        lo, hi = shard_bounds(total, n_shards, s)
        sel = (gpos >= lo - margin) & (gpos < hi + margin)
        part = Decoy(
            index=_subset_index(idx, sel),
            chrom_of_path=decoy.chrom_of_path,
            cluster_spans=decoy.cluster_spans,
            overlap_frac=decoy.overlap_frac,
            margin=decoy.margin,
            span_lo=decoy.span_lo,
            span_hi=decoy.span_hi,
        )
        shards.append(DecoyShard(
            decoy=part, shard=s, n_shards=n_shards,
            own_lo=lo, own_hi=hi, chrom_offset=off[:-1],
        ))
    return shards


def build_decoy_shard(
    panel,
    n_shards: int,
    shard: int,
    k: int,
    w: int,
    max_hits_per_minimizer: int = 64,
    margin: int = DEFAULT_MARGIN,
) -> DecoyShard:
    """Build ONE genomic-range decoy shard without the full hit table.

    The occurrence cap must stay GLOBAL to match the unsharded index (a
    genome-wide repeat can have per-shard counts under the cap), so the
    construction is two-pass: (1) stream per-chrom minimizer hashes and
    accumulate global counts (hashes only — 4 bytes/minimizer transient);
    (2) re-extract each chrom's minimizers and keep hits inside this
    shard's widened range whose hash passes the global cap. Peak memory is
    the hash stream plus this shard's hits — never the full sorted table.

    Reference behavior being reproduced: align/decoy.py build_decoy
    (itself the minigraph whole-graph index analog, SURVEY §2.1.1).
    """
    from ..align.minimizer import extract_minimizers

    graph = panel.graph
    chrom_of_path = list(graph.chrom_order)
    lens = [len(graph.chrom_seq[c]) for c in chrom_of_path]
    off = _chrom_offsets(np.array(lens, dtype=np.int64))
    total = int(off[-1])
    lo, hi = shard_bounds(total, n_shards, shard)

    # Pass 1: global occurrence counts (hashes only).
    per_chrom_hashes: List[np.ndarray] = []
    for chrom in chrom_of_path:
        codes = encode_ascii(graph.chrom_seq[chrom])
        per_chrom_hashes.append(extract_minimizers(codes, k, w).hash)
    all_hash = (
        np.concatenate(per_chrom_hashes)
        if per_chrom_hashes
        else np.zeros(0, np.uint32)
    )
    glob_uniq, glob_counts = np.unique(all_hash, return_counts=True)
    del all_hash
    keep_hash = glob_uniq[glob_counts <= max_hits_per_minimizer]

    # Pass 2: collect this shard's hits.
    hashes, paths, positions, strands = [], [], [], []
    for pid, chrom in enumerate(chrom_of_path):
        c_lo, c_hi = int(off[pid]), int(off[pid + 1])
        if c_hi <= lo - margin or c_lo >= hi + margin:
            per_chrom_hashes[pid] = None
            continue
        codes = encode_ascii(graph.chrom_seq[chrom])
        mins = extract_minimizers(codes, k, w)
        per_chrom_hashes[pid] = None
        g = c_lo + mins.pos.astype(np.int64)
        sel = (g >= lo - margin) & (g < hi + margin)
        ok = sel.copy()
        if len(keep_hash):
            h = mins.hash[sel]
            i = np.clip(
                np.searchsorted(keep_hash, h), 0, len(keep_hash) - 1
            )
            ok[sel] = keep_hash[i] == h
        else:
            ok[sel] = False
        hashes.append(mins.hash[ok])
        positions.append(mins.pos[ok])
        strands.append(mins.strand[ok])
        paths.append(np.full(int(ok.sum()), pid, dtype=np.int32))

    all_hash = np.concatenate(hashes) if hashes else np.zeros(0, np.uint32)
    all_path = np.concatenate(paths) if paths else np.zeros(0, np.int32)
    all_pos = np.concatenate(positions) if positions else np.zeros(0, np.int32)
    all_strand = (
        np.concatenate(strands) if strands else np.zeros(0, np.int8)
    )
    order = np.argsort(all_hash, kind="stable")
    all_hash = all_hash[order]
    uniq, start = np.unique(all_hash, return_index=True)
    hit_start = np.append(start, len(all_hash)).astype(np.int64)
    n_paths = len(chrom_of_path)
    index = PanelIndex(
        k=k, w=w, uniq_hash=uniq, hit_start=hit_start,
        hit_path=all_path[order], hit_pos=all_pos[order],
        hit_strand=all_strand[order],
        path_cluster=np.arange(n_paths, dtype=np.int32),
        path_len=np.array(lens, dtype=np.int32),
        path_first_j=np.zeros(n_paths, dtype=np.int32),
        path_last_j=np.zeros(n_paths, dtype=np.int32),
    )
    # Cluster genomic spans: identical for every shard; reuse build_decoy's
    # span computation by building a hits-free decoy would rescan chroms,
    # so compute through the same helper on the cheap path: spans depend
    # only on the panel, not on the hit table.
    spans = _cluster_spans(panel)
    part = Decoy(index=index, chrom_of_path=chrom_of_path,
                 cluster_spans=spans)
    return DecoyShard(
        decoy=part, shard=shard, n_shards=n_shards,
        own_lo=lo, own_hi=hi, chrom_offset=off[:-1],
    )


def _cluster_spans(panel):
    """Panel-cluster genomic spans (same computation as build_decoy)."""
    graph = panel.graph
    spans = []
    for cl in panel.clusters:
        span = {}

        def widen(chrom, lo, hi):
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
                    if node.is_alt:
                        widen(node.chrom, node.start0, node.end0)
                    elif strand == 0:
                        widen(node.chrom, node.start0 + a, node.start0 + b - 1)
                    else:
                        widen(node.chrom, node.end0 - (b - 1), node.end0 - a)
                off += nlen
        spans.append(span)
    return spans


def claim_owned_chains(
    dec: Candidates, reads: ReadSet, shard: DecoyShard
) -> Candidates:
    """Keep only decoy chains whose genomic start this shard OWNS.

    Every chain is claimed by exactly one shard, so the union over shards
    of claimed chains equals the unsharded chain set (margin argument in
    the module docstring).
    """
    if len(dec) == 0:
        return dec
    (d_chain, _d_read, d_path, _d_str, _d_sup, _qlo, _qhi, d_tlo, _d_thi) = (
        _chain_table(dec, reads.lengths)
    )
    g_start = shard.chrom_offset[d_path] + d_tlo
    owned = (g_start >= shard.own_lo) & (g_start < shard.own_hi)
    if owned.all():
        return dec
    ci = np.searchsorted(d_chain, dec.chain)
    ci = np.clip(ci, 0, max(0, len(d_chain) - 1))
    row_owned = owned[ci] & (d_chain[ci] == dec.chain)
    return dec.take(row_owned)


def _uncapped(cp: ChainParams) -> ChainParams:
    import dataclasses

    return dataclasses.replace(cp, max_chains=1 << 30)


def _concat_candidates(parts: List[Candidates]) -> Candidates:
    """Row-concatenate candidate sets, keeping chain ids globally unique."""
    parts = [p for p in parts if len(p)]
    if not parts:
        from ..align.seed import _empty_candidates

        return _empty_candidates()
    fields = ("read", "path", "strand", "d0", "n_anchors", "q_lo", "q_hi",
              "a_lo", "a_hi", "dec_other", "dec_same", "head_diag")
    merged = {
        f: np.concatenate([getattr(p, f) for p in parts]) for f in fields
    }
    chains = []
    off = 0
    for p in parts:
        chains.append(p.chain + off)
        off += int(p.chain.max()) + 1 if len(p.chain) else 0
    return Candidates(chain=np.concatenate(chains), **merged)


def union_decoy_chains(
    reads: ReadSet,
    shards: Sequence[DecoyShard],
    chain_params: ChainParams,
    threads: int = 0,
) -> Candidates:
    """Seed every shard UNCAPPED, claim by ownership, and union.

    Uncapped because the per-group ``max_chains`` truncation is GLOBAL in
    the unsharded path (one group spans genomic locations in several
    shards), so per-shard truncation would resurrect chains the global
    top-``max_chains`` dropped; the global cap is re-applied on the union
    by :func:`apply_global_chain_cap`.
    """
    parts = []
    cp_open = _uncapped(chain_params)
    for shard in shards:
        dec = seed_candidates(
            reads, shard.decoy.index, chain_params=cp_open, threads=threads
        )
        parts.append(claim_owned_chains(dec, reads, shard))
    return _concat_candidates(parts)


def apply_global_chain_cap(
    dec: Candidates, n_paths: int, max_chains: int
) -> Candidates:
    """Top-``max_chains`` chains per (read, path, strand), exactly as the
    chainer's stable truncation: anchor count descending, ties in
    CREATION ORDER = ascending (head rpos, head diag) — anchors are
    processed in ascending (rpos, diag), so chain creation follows it
    (fastio.cpp chain_one_read). Rows come back read-sorted with chain
    blocks contiguous (the layout suppress_candidates' native path
    requires)."""
    if len(dec) == 0:
        return dec
    uniq, first = np.unique(dec.chain, return_index=True)
    c_read = dec.read[first].astype(np.int64)
    c_path = dec.path[first].astype(np.int64)
    c_strand = dec.strand[first].astype(np.int64)
    c_count = dec.n_anchors[first].astype(np.int64)
    c_alo = dec.a_lo[first].astype(np.int64)
    c_hd = dec.head_diag[first].astype(np.int64)
    group = (c_read * n_paths + c_path) * 2 + c_strand
    order = np.lexsort((c_hd, c_alo, -c_count, group))
    grp_s = group[order]
    new_grp = np.concatenate([[True], grp_s[1:] != grp_s[:-1]])
    starts = np.flatnonzero(new_grp)
    grp_id = np.cumsum(new_grp) - 1
    rank = np.arange(len(order)) - starts[grp_id]
    keep_chain = np.zeros(len(uniq), dtype=bool)
    keep_chain[order[rank < max_chains]] = True
    ci = np.searchsorted(uniq, dec.chain)
    rows = keep_chain[ci]
    kept = dec.take(rows)
    # Read-sorted, chain blocks contiguous, block order preserved
    # (take() accepts an index permutation like numpy fancy indexing) —
    # then chain ids renumbered in row order so ascending id == ascending
    # read, the layout _chain_table/svt_suppress require.
    final = np.lexsort((np.arange(len(kept)), kept.chain, kept.read))
    out = kept.take(final)
    if len(out):
        change = np.concatenate([[True], out.chain[1:] != out.chain[:-1]])
        out.chain = np.cumsum(change) - 1
    return out


def suppress_candidates_sharded(
    reads: ReadSet,
    cands: Candidates,
    index: PanelIndex,
    shards: List[DecoyShard],
    chain_params: ChainParams,
    threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sharded-decoy suppression: byte-equal to the unsharded path.

    Single-process driver (shards seeded in sequence — the memory shape a
    (data x graph) process grid runs in parallel, one shard per graph
    rank). The cross-shard exchange is the CLAIMED CHAIN TABLE — a few
    ints per chain, thousands of times smaller than the hit tables — and
    the margin computation is a max-reduction (associative), so the pod
    form is a gather of chain tables (or a per-rank suppress + margin
    max-allreduce) on the graph axis, next to the existing count psum.
    Returns (keep, dec_other, dec_same).
    """
    from ..align.decoy import suppress_candidates

    dec = union_decoy_chains(reads, shards, chain_params, threads=threads)
    n_paths = len(shards[0].decoy.index.path_len) if shards else 1
    dec = apply_global_chain_cap(dec, n_paths, chain_params.max_chains)
    # Full-genome metadata (cluster spans, chrom list) is identical in
    # every shard; any shard's Decoy carries it.
    return suppress_candidates(
        reads, cands, index, shards[0].decoy, chain_params, threads=threads,
        dec=dec, return_margins=True,
    )
