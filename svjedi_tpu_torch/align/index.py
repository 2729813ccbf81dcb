# Copied verbatim from svjedi_tpu/align/index.py.
"""Minimizer index over the panel (sorted-array hash table).

The reference's analog is minigraph's minimizer index over graph node
sequences; ours indexes panel *paths* (graph/cluster.py), so junction-
spanning k-mers are indexed for free — a k-mer across a DEL/INV/BND join
exists in the path sequence itself (SURVEY §7.3a's "junction-spanning
k-mers across edges").

Sorted arrays + binary search rather than a hash map: lookups are a batched
``searchsorted`` (an XLA-friendly gather pattern), construction is a sort.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..graph.cluster import Panel
from .minimizer import extract_minimizers


@dataclass
class PanelIndex:
    k: int
    w: int
    #: sorted unique minimizer hashes with their hit ranges
    uniq_hash: np.ndarray  # uint32 (U,)
    hit_start: np.ndarray  # int64 (U+1,) prefix offsets into hit arrays
    #: hit payloads, grouped by hash
    hit_path: np.ndarray  # int32 path id
    hit_pos: np.ndarray  # int32 k-mer start within path seq
    hit_strand: np.ndarray  # int8 canonical-strand flag of the panel k-mer
    #: per-path cluster id (convenience copy)
    path_cluster: np.ndarray  # int32
    path_len: np.ndarray  # int32
    #: first/last owned-junction offset per path (path-space)
    path_first_j: np.ndarray  # int32
    path_last_j: np.ndarray  # int32

    #: log2 of the prefilter bitmap size in bits (2 MiB of bitmap): with
    #: ~10^4-10^6 panel hashes the false-positive rate stays well below 1%.
    BITMAP_LOG2 = 24

    def hash_bitmap(self) -> np.ndarray:
        """Bit-per-masked-hash membership filter for the native seed scan.

        Read minimizers overwhelmingly miss the panel (the panel covers only
        breakpoint neighborhoods); the native scanner tests this bitmap and
        drops misses before they ever reach numpy. False positives fall out
        of the exact :meth:`lookup`.
        """
        bm = getattr(self, "_bitmap", None)
        if bm is None:
            bm = np.zeros(1 << (self.BITMAP_LOG2 - 3), dtype=np.uint8)
            bits = self.uniq_hash.astype(np.uint32) & np.uint32(
                (1 << self.BITMAP_LOG2) - 1
            )
            np.bitwise_or.at(
                bm,
                (bits >> np.uint32(3)).astype(np.int64),
                (np.uint8(1) << (bits & np.uint32(7)).astype(np.uint8)),
            )
            self._bitmap = bm
        return bm

    def bitmap_if_useful(self):
        """The prefilter bitmap, or None when it cannot prune.

        The bitmap rejects read minimizers absent from the index before
        the exact lookup. With a PANEL index (10^4-10^6 hashes in 2^24
        bits) it rejects ~99%+; with a genome-scale MERGED panel+decoy
        index the hash set approaches the bitmap size and most probes
        pass anyway — then the 2 MB random-access table is pure L2-miss
        overhead (measured: ~0.3-0.5 cpu-s per 13 M-minimizer chunk at
        50 Mb). Skipping it is bit-identical: the exact lookup rejects
        exactly the hashes the bitmap would have.
        """
        if len(self.uniq_hash) > (1 << self.BITMAP_LOG2) // 8:
            return None
        return self.hash_bitmap()

    def packed_hits(self) -> np.ndarray:
        """Interleaved uint64 hit stream: (path << 33) | (strand << 32) | pos.

        The native expand phase walks hit lists at random offsets; three
        parallel arrays cost three cache-miss streams per list where one
        packed array costs one (fastio.cpp svt_chain6). Built lazily once
        per index (8 bytes/hit — the three source arrays stay for every
        other consumer).
        """
        ph = getattr(self, "_packed_hits", None)
        if ph is None:
            ph = (
                (self.hit_path.astype(np.uint64) << np.uint64(33))
                | (self.hit_strand.astype(np.uint8).astype(np.uint64)
                   << np.uint64(32))
                | self.hit_pos.astype(np.uint32).astype(np.uint64)
            )
            self._packed_hits = ph
        return ph

    def native_lookup(self) -> int:
        """Opaque native exact-hash table handle (0 when unavailable).

        Built lazily once per index and reused by every chunk's native
        chain call (svt_chain3); freed with the index object.
        """
        handle = getattr(self, "_native_lookup", None)
        if handle is None:
            from ..utils.native import load_native

            native = load_native()
            handle = (
                native.lookup_build(self.uniq_hash) if native is not None
                else 0
            )
            self._native_lookup = handle
            if handle:
                import weakref

                weakref.finalize(self, native.lookup_free, handle)
        return handle

    def lookup(
        self, hashes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (start, end) hit ranges for each query hash (0-len when absent)."""
        idx = np.searchsorted(self.uniq_hash, hashes)
        idx = np.clip(idx, 0, len(self.uniq_hash) - 1)
        found = (len(self.uniq_hash) > 0) & (self.uniq_hash[idx] == hashes)
        start = np.where(found, self.hit_start[idx], 0)
        end = np.where(found, self.hit_start[idx + 1], 0)
        return start, end


def merge_indexes(a: PanelIndex, b: PanelIndex) -> PanelIndex:
    """One index over both hit tables; ``b``'s path ids offset after ``a``'s.

    Seeding cost is dominated by the per-read minimizer scan, which is
    identical for every index — merging the panel and decoy indexes lets one
    scan serve both. Chaining groups by (read, path, strand), so the merged
    seeding result is exactly the union of the separate results (native
    chainer: fastio.cpp chain_reads has no cross-path state).
    """
    if (a.k, a.w) != (b.k, b.w):
        raise ValueError("cannot merge indexes with different k/w")
    off = len(a.path_len)
    ha = np.repeat(a.uniq_hash, np.diff(a.hit_start))
    hb = np.repeat(b.uniq_hash, np.diff(b.hit_start))
    all_hash = np.concatenate([ha, hb])
    all_path = np.concatenate([a.hit_path, b.hit_path + off])
    all_pos = np.concatenate([a.hit_pos, b.hit_pos])
    all_strand = np.concatenate([a.hit_strand, b.hit_strand])
    order = np.argsort(all_hash, kind="stable")
    all_hash = all_hash[order]
    uniq, start = np.unique(all_hash, return_index=True)
    hit_start = np.append(start, len(all_hash)).astype(np.int64)
    cluster_off = int(a.path_cluster.max()) + 1 if len(a.path_cluster) else 0
    return PanelIndex(
        k=a.k,
        w=a.w,
        uniq_hash=uniq,
        hit_start=hit_start,
        hit_path=all_path[order],
        hit_pos=all_pos[order],
        hit_strand=all_strand[order],
        path_cluster=np.concatenate(
            [a.path_cluster, b.path_cluster + cluster_off]
        ),
        path_len=np.concatenate([a.path_len, b.path_len]),
        path_first_j=np.concatenate([a.path_first_j, b.path_first_j]),
        path_last_j=np.concatenate([a.path_last_j, b.path_last_j]),
    )


def build_panel_index(
    panel: Panel, k: int = 15, w: int = 10, max_hits_per_minimizer: int = 64
) -> PanelIndex:
    """Index every panel path's minimizers."""
    hashes: List[np.ndarray] = []
    paths: List[np.ndarray] = []
    positions: List[np.ndarray] = []
    strands: List[np.ndarray] = []
    for pid, path in enumerate(panel.paths):
        mins = extract_minimizers(path.seq, k, w)
        hashes.append(mins.hash)
        positions.append(mins.pos)
        strands.append(mins.strand)
        paths.append(np.full(len(mins.pos), pid, dtype=np.int32))

    all_hash = np.concatenate(hashes) if hashes else np.zeros(0, np.uint64)
    all_path = np.concatenate(paths) if paths else np.zeros(0, np.int32)
    all_pos = np.concatenate(positions) if positions else np.zeros(0, np.int32)
    all_strand = np.concatenate(strands) if strands else np.zeros(0, np.int8)

    order = np.argsort(all_hash, kind="stable")
    all_hash = all_hash[order]
    all_path = all_path[order]
    all_pos = all_pos[order]
    all_strand = all_strand[order]

    uniq, start = np.unique(all_hash, return_index=True)
    counts = np.diff(np.append(start, len(all_hash)))

    # Drop ultra-frequent minimizers (repeats): keeps seeding O(reads).
    # Hits of one hash are contiguous in the sorted arrays, so the kept
    # rows are exactly the per-unique keep flag repeated per hit count —
    # one vectorized mask instead of millions of tiny np.arange slices
    # (the old form allocated one array PER UNIQUE HASH; at genome scale
    # that is tens of millions of allocations and was the dominant
    # index-build transient).
    keep = counts <= max_hits_per_minimizer
    keep_hits = np.repeat(keep, counts)
    uniq = uniq[keep]
    all_path = all_path[keep_hits]
    all_pos = all_pos[keep_hits]
    all_strand = all_strand[keep_hits]
    new_counts = counts[keep]
    hit_start = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(new_counts, out=hit_start[1:])

    return PanelIndex(
        k=k,
        w=w,
        uniq_hash=uniq,
        hit_start=hit_start,
        hit_path=all_path,
        hit_pos=all_pos,
        hit_strand=all_strand,
        path_cluster=np.array(
            [p.cluster_id for p in panel.paths], dtype=np.int32
        ),
        path_len=np.array([p.length for p in panel.paths], dtype=np.int32),
        path_first_j=np.array(
            [min((o[2] for o in p.owned), default=0) for p in panel.paths],
            dtype=np.int32,
        ),
        path_last_j=np.array(
            [max((o[2] for o in p.owned), default=0) for p in panel.paths],
            dtype=np.int32,
        ),
    )
