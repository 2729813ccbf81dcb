# Copied verbatim from svjedi_tpu/align/seed.py.
"""Seeding: read minimizers → panel anchors → chained block candidates.

The reference's aligner (minigraph, invoked at svjedi-graph.py:104) chains
minimizer anchors and base-aligns along the chain, so the DP band follows
the read's indel drift. A fixed-diagonal band cannot: at ~10% long-read
error the alignment drifts hundreds of bases off any single diagonal over
a few kb, and a 128-wide band silently truncates it. This module therefore
emits **chain blocks**:

1. anchors per (read, path, strand) are chained greedily with a drift
   tolerance (``chain_drift_abs + chain_drift_permille/1000 * gap``);
2. the top ``max_chains`` chains (by anchor count, >= ``min_anchors``)
   survive;
3. each chain is cut into ``block_rows``-row read blocks; every block is an
   independent fixed-shape DP problem whose diagonal ``d0`` is the median
   anchor diagonal of the block (interpolated for anchor-free interior
   blocks, edge-extended for the extension blocks) — the piecewise-banded
   equivalent of aligning along the chain, with the Pallas kernel unchanged.

Block results are re-aggregated per chain by align/pipeline.py (score sum,
span union) before winner selection.

The native path (``svt_chain`` in native/fastio.cpp) implements the same
algorithm in threaded C++; the numpy+Python fallback here is the semantics
reference (tests compare the two).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fastq import ReadSet
from ..utils.native import load_native
from .index import PanelIndex
from .minimizer import extract_minimizers_flat


@dataclass
class Candidates:
    """Flat chain-block arrays (one row per DP problem)."""

    read: np.ndarray  # int32
    path: np.ndarray  # int32
    strand: np.ndarray  # int8 (0: read fwd vs path; 1: revcomp read vs path)
    d0: np.ndarray  # int32 block diagonal (path_pos - read_pos)
    n_anchors: np.ndarray  # int32 anchors of the whole chain
    chain: np.ndarray = None  # int64 global chain id (blocks contiguous)
    q_lo: np.ndarray = None  # int32 block read-window start (oriented read)
    q_hi: np.ndarray = None  # int32 block read-window end (exclusive)
    #: chain anchor extent (oriented read coords; same on every block row)
    a_lo: np.ndarray = None  # int32
    a_hi: np.ndarray = None  # int32
    #: decoy-competition margins (strongest elsewhere / at-locus decoy
    #: anchor support for the chain; decoy.suppress_candidates margins) —
    #: zeros until the suppression stage fills them. Feed the mapq model.
    dec_other: np.ndarray = None  # int32
    dec_same: np.ndarray = None  # int32
    #: chain head-anchor diagonal (same on every block row): with a_lo it
    #: keys the chain's creation order inside its (read, path, strand)
    #: group — needed by dist/decoy_shard.py to re-apply the global
    #: max_chains truncation with the exact stable tie-break.
    head_diag: np.ndarray = None  # int32

    def __post_init__(self):
        if self.chain is None:
            self.chain = np.arange(len(self.read), dtype=np.int64)
        if self.q_lo is None:
            self.q_lo = np.zeros(len(self.read), dtype=np.int32)
        if self.q_hi is None:
            self.q_hi = np.full(len(self.read), 1 << 30, dtype=np.int32)
        if self.a_lo is None:
            self.a_lo = self.q_lo
        if self.a_hi is None:
            self.a_hi = self.q_hi
        if self.dec_other is None:
            self.dec_other = np.zeros(len(self.read), dtype=np.int32)
        if self.dec_same is None:
            self.dec_same = np.zeros(len(self.read), dtype=np.int32)
        if self.head_diag is None:
            self.head_diag = np.zeros(len(self.read), dtype=np.int32)

    def __len__(self) -> int:
        return len(self.read)

    def take(self, mask: np.ndarray, path_offset: int = 0) -> "Candidates":
        """Row subset (order preserved; chain blocks stay contiguous)."""
        path = self.path[mask]
        if path_offset:
            path = path + np.int32(path_offset)
        return Candidates(
            read=self.read[mask],
            path=path,
            strand=self.strand[mask],
            d0=self.d0[mask],
            n_anchors=self.n_anchors[mask],
            chain=self.chain[mask],
            q_lo=self.q_lo[mask],
            q_hi=self.q_hi[mask],
            a_lo=self.a_lo[mask],
            a_hi=self.a_hi[mask],
            dec_other=self.dec_other[mask],
            dec_same=self.dec_same[mask],
            head_diag=self.head_diag[mask],
        )


@dataclass(frozen=True)
class ChainParams:
    min_anchors: int = 2
    max_chains: int = 4
    max_gap: int = 4096
    drift_abs: int = 64
    drift_permille: int = 150
    block_rows: int = 1536
    ext_min_anchors: int = 4


def _expand_ranges(start: np.ndarray, end: np.ndarray):
    """Concatenate [start_i, end_i) ranges into one index array + repeats."""
    counts = (end - start).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), counts
    prefix = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=prefix[1:])
    flat = np.arange(total, dtype=np.int64) - np.repeat(prefix, counts)
    return np.repeat(start.astype(np.int64), counts) + flat, counts


def _chain_group(rpos: np.ndarray, diag: np.ndarray, cp: ChainParams):
    """Chain one (read, path, strand) group's anchors.

    Anchors must be sorted by (rpos, diag). Returns a list of chains, each
    a list of anchor indices into the group arrays, in creation order.
    """
    chains = []  # [last_rpos, last_diag, [indices]]
    for i in range(len(rpos)):
        r, d = int(rpos[i]), int(diag[i])
        best_j = -1
        best_dd = None
        for j, ch in enumerate(chains):
            gap = r - ch[0]
            if gap > cp.max_gap:
                continue
            dd = abs(d - ch[1])
            if dd > cp.drift_abs + (cp.drift_permille * gap) // 1000:
                continue
            if best_dd is None or dd < best_dd:
                best_dd = dd
                best_j = j
        if best_j >= 0:
            ch = chains[best_j]
            ch[0], ch[1] = r, d
            ch[2].append(i)
        else:
            chains.append([r, d, [i]])
    return [ch[2] for ch in chains]


def _blocks_for_chain(
    rpos: np.ndarray, diag: np.ndarray, idx, rlen: int, cp: ChainParams
):
    """Cut one chain into (q_lo, q_hi, d0) blocks (see module docstring)."""
    R = cp.block_rows
    rs = rpos[idx]
    ds = diag[idx]
    b_first = int(rs[0]) // R
    b_last = int(rs[-1]) // R
    b_max = max(0, (rlen - 1) // R)
    b0, b1 = b_first, b_last
    if len(idx) >= cp.ext_min_anchors:
        b0, b1 = max(0, b0 - 1), min(b_max, b1 + 1)
    n_blocks = b1 - b0 + 1
    d0s = np.full(n_blocks, np.iinfo(np.int64).min, dtype=np.int64)
    for bi in range(b_first, b_last + 1):
        lo, hi = np.searchsorted(rs, [bi * R, (bi + 1) * R])
        if hi > lo:
            sub = np.sort(ds[lo:hi])
            d0s[bi - b0] = sub[(len(sub) - 1) // 2]
    # Interpolate anchor-free interior blocks; edge-extend the rest.
    known = np.flatnonzero(d0s != np.iinfo(np.int64).min)
    for bi in range(n_blocks):
        if d0s[bi] != np.iinfo(np.int64).min:
            continue
        left = known[known < bi]
        right = known[known > bi]
        if len(left) and len(right):
            a, b = int(left[-1]), int(right[0])
            v = d0s[a] + (d0s[b] - d0s[a]) * (bi - a) / (b - a)
            # round half away from zero == C++ llround (native parity)
            d0s[bi] = int(np.sign(v) * np.floor(np.abs(v) + 0.5))
        elif len(left):
            d0s[bi] = d0s[int(left[-1])]
        else:
            d0s[bi] = d0s[int(right[0])]
    out = []
    for bi in range(n_blocks):
        b = b0 + bi
        out.append((b * R, min((b + 1) * R, rlen), int(d0s[bi])))
    return out


def seed_candidates(
    reads: ReadSet,
    index: PanelIndex,
    chain_params: ChainParams = ChainParams(),
    threads: int = 0,
    panel_path_limit: int = 0,
    mins=None,
    bits=None,
) -> Candidates:
    """Compute chain-block alignment candidates for every read.

    ``threads`` bounds the native scan's thread count (0 = all hardware
    threads); it is the working equivalent of the reference's ``-t``.
    ``panel_path_limit`` > 0 (merged panel+decoy index): reads with no
    anchor on a path id below the limit are skipped before chaining — they
    can never contribute a count, and decoy chains are consulted only for
    reads with panel chains.
    ``mins`` = precomputed (read_id, pos, hash, strand) minimizer arrays
    (read-major, position-sorted) — the on-device scan path
    (align/dev_scan.py); skips the host scan and goes straight to lookup +
    chaining (native ``svt_chain4``, or the numpy path below).
    ``bits`` = the on-device scan's packed emission bitmask
    (align/dev_scan.py) — lookup + chaining via native ``svt_chain5``;
    falls back to the full host scan when the library predates it.
    """
    cp = chain_params
    rlen = reads.lengths
    native = load_native()
    if bits is not None and native is not None:
        res = native.chain_from_bitmask(
            reads.codes, reads.offsets, bits, index.k, index.w,
            bitmap=index.bitmap_if_useful(), bitmap_log2=index.BITMAP_LOG2,
            uniq_hash=index.uniq_hash, hit_start=index.hit_start,
            hit_path=index.hit_path, hit_pos=index.hit_pos,
            hit_strand=index.hit_strand,
            params=cp, n_threads=threads,
            panel_path_limit=panel_path_limit,
            lookup=index.native_lookup(),
            hit_packed=index.packed_hits(),
        )
        if res is not None:
            (read, path, strand, d0, support, chain_local, q_lo, q_hi,
             a_lo, a_hi, head_diag) = res
            return Candidates(
                read=read, path=path, strand=strand, d0=d0,
                n_anchors=support,
                chain=_globalize_chains(read, chain_local),
                q_lo=q_lo, q_hi=q_hi, a_lo=a_lo, a_hi=a_hi,
                head_diag=head_diag,
            )
    if mins is not None:
        if native is not None and hasattr(native._lib, "svt_chain4"):
            res = native.chain_from_minimizers(
                reads.offsets, mins[0], mins[1], mins[2], mins[3],
                index.k, uniq_hash=index.uniq_hash,
                hit_start=index.hit_start, hit_path=index.hit_path,
                hit_pos=index.hit_pos, hit_strand=index.hit_strand,
                params=cp, n_threads=threads,
                panel_path_limit=panel_path_limit,
                lookup=index.native_lookup(),
            )
            if res is not None:
                (read, path, strand, d0, support, chain_local, q_lo, q_hi,
                 a_lo, a_hi, head_diag) = res
                return Candidates(
                    read=read, path=path, strand=strand, d0=d0,
                    n_anchors=support,
                    chain=_globalize_chains(read, chain_local),
                    q_lo=q_lo, q_hi=q_hi, a_lo=a_lo, a_hi=a_hi,
                    head_diag=head_diag,
                )
    elif native is not None and hasattr(native._lib, "svt_chain"):
        res = native.chain(
            reads.codes, reads.offsets, index.k, index.w,
            bitmap=index.bitmap_if_useful(), bitmap_log2=index.BITMAP_LOG2,
            uniq_hash=index.uniq_hash, hit_start=index.hit_start,
            hit_path=index.hit_path, hit_pos=index.hit_pos,
            hit_strand=index.hit_strand,
            params=cp, n_threads=threads,
            panel_path_limit=panel_path_limit,
            lookup=index.native_lookup(),
        )
        if res is not None:
            (read, path, strand, d0, support, chain_local, q_lo, q_hi,
             a_lo, a_hi, head_diag) = res
            return Candidates(
                read=read, path=path, strand=strand, d0=d0,
                n_anchors=support,
                chain=_globalize_chains(read, chain_local),
                q_lo=q_lo, q_hi=q_hi, a_lo=a_lo, a_hi=a_hi,
                head_diag=head_diag,
            )
    native_result = mins if mins is not None else (
        native.minimizers(
            reads.codes, reads.offsets, index.k, index.w,
            bitmap=index.bitmap_if_useful(), bitmap_log2=index.BITMAP_LOG2,
            n_threads=threads,
        )
        if native is not None
        else None
    )
    if native_result is not None:
        q_read, q_pos, q_hash, q_strand = native_result
    else:
        flat = extract_minimizers_flat(
            reads.codes, reads.offsets, index.k, index.w
        )
        q_read, q_pos = flat.read_id, flat.pos
        q_hash, q_strand = flat.hash, flat.strand
    if len(q_pos) == 0:
        return _empty_candidates()

    start, end = index.lookup(q_hash)
    hit_idx, counts = _expand_ranges(start, end)

    a_read = np.repeat(q_read, counts)
    a_rpos = np.repeat(q_pos, counts)
    a_rstrand = np.repeat(q_strand, counts)
    a_path = index.hit_path[hit_idx]
    a_tpos = index.hit_pos[hit_idx]
    a_tstrand = index.hit_strand[hit_idx]

    if panel_path_limit > 0 and len(a_read):
        has_panel = np.zeros(reads.n_reads, dtype=bool)
        has_panel[a_read[a_path < panel_path_limit]] = True
        keep_a = has_panel[a_read]
        a_read, a_rpos = a_read[keep_a], a_rpos[keep_a]
        a_rstrand = a_rstrand[keep_a]
        a_path, a_tpos = a_path[keep_a], a_tpos[keep_a]
        a_tstrand = a_tstrand[keep_a]

    strand = (a_rstrand ^ a_tstrand).astype(np.int8)
    # Effective read coordinate: for reverse-strand candidates we align the
    # reverse-complemented read, where this k-mer starts at rlen - k - pos.
    rlen_a = rlen[a_read]
    rpos_eff = np.where(strand == 0, a_rpos, rlen_a - index.k - a_rpos)
    diag = (a_tpos - rpos_eff).astype(np.int64)

    if len(diag) == 0:
        return _empty_candidates()

    n_paths = int(index.path_cluster.shape[0])
    group = (a_read.astype(np.int64) * n_paths + a_path) * 2 + strand
    order = np.lexsort((diag, rpos_eff, group))
    group_s = group[order]
    rpos_s = rpos_eff[order].astype(np.int64)
    diag_s = diag[order]

    grp_change = np.empty(len(group_s), dtype=bool)
    grp_change[0] = True
    np.not_equal(group_s[1:], group_s[:-1], out=grp_change[1:])
    starts = np.flatnonzero(grp_change)
    ends = np.append(starts[1:], len(group_s))

    rows_read, rows_path, rows_strand = [], [], []
    rows_d0, rows_support, rows_chain = [], [], []
    rows_qlo, rows_qhi, rows_alo, rows_ahi = [], [], [], []
    rows_hd = []
    chain_counter = 0
    for s, e in zip(starts, ends):
        g = int(group_s[s])
        g_strand = g % 2
        g_path = (g // 2) % n_paths
        g_read = g // (2 * n_paths)
        rp = rpos_s[s:e]
        dg = diag_s[s:e]
        chains = _chain_group(rp, dg, cp)
        kept = [c for c in chains if len(c) >= cp.min_anchors]
        # Top max_chains by anchor count; stable order = creation order.
        kept.sort(key=len, reverse=True)
        kept = kept[: cp.max_chains]
        for idx in kept:
            blocks = _blocks_for_chain(
                rp, dg, np.asarray(idx), int(rlen[g_read]), cp
            )
            a_lo = int(rp[idx[0]])
            a_hi = min(int(rp[idx[-1]]) + index.k, int(rlen[g_read]))
            hd = int(dg[idx[0]])
            for q_lo, q_hi, d0 in blocks:
                rows_read.append(g_read)
                rows_path.append(g_path)
                rows_strand.append(g_strand)
                rows_d0.append(d0)
                rows_support.append(len(idx))
                rows_chain.append(chain_counter)
                rows_qlo.append(q_lo)
                rows_qhi.append(q_hi)
                rows_alo.append(a_lo)
                rows_ahi.append(a_hi)
                rows_hd.append(hd)
            chain_counter += 1

    if not rows_read:
        return _empty_candidates()
    return Candidates(
        read=np.asarray(rows_read, np.int32),
        path=np.asarray(rows_path, np.int32),
        strand=np.asarray(rows_strand, np.int8),
        d0=np.asarray(rows_d0, np.int32),
        n_anchors=np.asarray(rows_support, np.int32),
        chain=np.asarray(rows_chain, np.int64),
        q_lo=np.asarray(rows_qlo, np.int32),
        q_hi=np.asarray(rows_qhi, np.int32),
        a_lo=np.asarray(rows_alo, np.int32),
        a_hi=np.asarray(rows_ahi, np.int32),
        head_diag=np.asarray(rows_hd, np.int32),
    )


def _empty_candidates() -> Candidates:
    z = np.zeros(0, np.int32)
    return Candidates(
        z, z, z.astype(np.int8), z, z,
        chain=np.zeros(0, np.int64), q_lo=z, q_hi=z,
    )


def _globalize_chains(read: np.ndarray, chain_local: np.ndarray) -> np.ndarray:
    """Remap per-read-local chain ids (native output) to global ids.

    Rows of one chain are contiguous; a new global id starts wherever
    (read, local) changes."""
    if len(read) == 0:
        return np.zeros(0, np.int64)
    change = np.empty(len(read), dtype=bool)
    change[0] = True
    change[1:] = (read[1:] != read[:-1]) | (chain_local[1:] != chain_local[:-1])
    return np.cumsum(change) - 1
