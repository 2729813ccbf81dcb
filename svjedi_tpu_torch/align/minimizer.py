# Copied verbatim from svjedi_tpu/align/minimizer.py.
"""Vectorized minimizer extraction (minimap2/minigraph-style seeding).

Canonical k-mers (min of forward / reverse-complement value) hashed with a
64-bit mixer; the leftmost-argmin position of each w-window is a minimizer.
Pure numpy (hot path is simple integer ops; the per-read volume is small
relative to DP, and the same code vectorizes on device later if it ever
shows up in profiles).

Sensitivity, not parity, is the requirement here: the reference's minigraph
uses (k=15, w=10) with its own hash; any good minimizer scheme that finds
the same loci works (SURVEY §7.3a).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

#: Sentinel hash for invalid (N-containing) k-mer positions.
_INVALID = np.uint32(0xFFFFFFFF)


def _mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 finalizer (public-domain mixing constants).

    32-bit hashing keeps the whole pipeline in uint32 (k <= 15 -> 30-bit
    k-mers): half the memory traffic of a 64-bit mix, and the ~0.2% birthday
    collision rate at millions of keys only adds noise anchors that the
    diagonal vote discards.
    """
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    with np.errstate(over="ignore"):
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


@dataclass
class Minimizers:
    pos: np.ndarray  # int32 k-mer start positions
    hash: np.ndarray  # uint32 canonical hashes
    strand: np.ndarray  # int8: 0 = forward k-mer is canonical, 1 = revcomp


def _kmer_values(codes: np.ndarray, k: int):
    """(fwd, rc, valid) uint32 arrays over all k-mer start positions.

    Rolling-shift formulation over contiguous uint32 buffers — no strided
    (n, k) window matrix, no 8-byte temporaries. Requires k <= 15 (2k bits
    must fit 32). In-place ops keep the temp count minimal.
    """
    if k > 15:
        raise ValueError("k must be <= 15 for 32-bit k-mer packing")
    n = len(codes) - k + 1
    c = codes.astype(np.uint32)
    comp = np.uint32(3) - c  # N (4) wraps; masked by `valid`
    fwd = np.zeros(n, dtype=np.uint32)
    rc = np.zeros(n, dtype=np.uint32)
    valid = np.ones(n, dtype=bool)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd <<= np.uint32(2)
            fwd |= c[j : n + j]
            rc <<= np.uint32(2)
            rc |= comp[k - 1 - j : n + k - 1 - j]
            valid &= codes[j : n + j] < 4
    return fwd, rc, valid


def _window_argmin(h: np.ndarray, w: int):
    """Leftmost argmin position of every length-w window (rolling, O(n·w))."""
    n = len(h) - w + 1
    m = h[:n].copy()
    arg = np.zeros(n, dtype=np.int64)
    for d in range(1, w):
        cand = h[d : n + d]
        take = cand < m
        np.minimum(m, cand, out=m)
        arg[take] = d
    return arg + np.arange(n, dtype=np.int64)


@dataclass
class FlatMinimizers:
    read_id: np.ndarray  # int32
    pos: np.ndarray  # int32, local to the read
    hash: np.ndarray  # uint32
    strand: np.ndarray  # int8


def extract_minimizers_flat(
    codes: np.ndarray, offsets: np.ndarray, k: int, w: int
) -> FlatMinimizers:
    """Minimizers for a whole concatenated read set in one pass.

    One vectorized sweep over the flat code array; k-mers crossing read
    boundaries are invalidated. Window-min selection runs on the flat array,
    so within w-1 positions of a read boundary the selected set can differ
    marginally from per-read extraction (a neighbor read's hash can shadow a
    would-be minimizer) — a sensitivity difference well below the anchor
    redundancy the seeder relies on, for a >100x cut in Python dispatch.
    """
    n = len(codes)
    if n < k or len(offsets) <= 1:
        z = np.zeros(0, np.int32)
        return FlatMinimizers(z, z, np.zeros(0, np.uint32), z.astype(np.int8))
    fwd, rc, valid = _kmer_values(codes, k)

    # Invalidate k-mers that straddle a read boundary.
    pos = np.arange(len(fwd), dtype=np.int64)
    read_id = np.searchsorted(offsets, pos, side="right") - 1
    valid &= pos + k <= offsets[read_id + 1]

    canonical = np.minimum(fwd, rc)
    strand = (rc < fwd).astype(np.int8)
    hashes = _mix32(canonical)
    hashes = np.where(valid & (fwd != rc), hashes, _INVALID)

    if len(hashes) < w:
        w = len(hashes)
    sel = np.unique(_window_argmin(hashes, w))
    sel = sel[hashes[sel] != _INVALID]
    rid = read_id[sel]
    return FlatMinimizers(
        read_id=rid.astype(np.int32),
        pos=(sel - offsets[rid]).astype(np.int32),
        hash=hashes[sel],
        strand=strand[sel],
    )


#: Window starts per extraction tile (see :func:`_extract_tiled`): 16 M
#: keeps per-tile temporaries ~0.5 GB where the untiled sweep over a
#: whole chromosome allocates ~40 bytes per base at once (measured as a
#: 10+ GB transient on a single 250 Mb chromosome during decoy build).
_TILE_WINDOWS = 1 << 24


def _extract_tiled(codes: np.ndarray, k: int, w: int) -> Minimizers:
    """Tile-at-a-time variant of :func:`extract_minimizers` — identical
    output by construction: a window's leftmost-argmin depends only on
    the window's own hashes, so extracting per tile with a (w-1)+(k-1)
    halo and deduplicating positions across tiles yields exactly the
    whole-array selection (a minimizer near a tile boundary may be
    emitted by both neighbors; values at a position are identical in
    either tile, so first-occurrence dedup is exact)."""
    n = len(codes)
    n_windows = (n - k + 1) - w + 1
    pos_parts, hash_parts, strand_parts = [], [], []
    for a in range(0, n_windows, _TILE_WINDOWS):
        b = min(n_windows, a + _TILE_WINDOWS)
        sub = codes[a : min(n, b + w - 1 + k - 1)]
        fwd, rc, valid = _kmer_values(sub, k)
        canonical = np.minimum(fwd, rc)
        strand = (rc < fwd).astype(np.int8)
        hashes = np.where(valid & (fwd != rc), _mix32(canonical), _INVALID)
        sel = np.unique(_window_argmin(hashes, w))
        sel = sel[hashes[sel] != _INVALID]
        pos_parts.append(sel + a)
        hash_parts.append(hashes[sel])
        strand_parts.append(strand[sel])
    pos = np.concatenate(pos_parts)
    hsh = np.concatenate(hash_parts)
    st = np.concatenate(strand_parts)
    pos, idx = np.unique(pos, return_index=True)
    return Minimizers(
        pos=pos.astype(np.int32), hash=hsh[idx], strand=st[idx]
    )


def extract_minimizers(codes: np.ndarray, k: int, w: int) -> Minimizers:
    """Minimizers of an int8 code sequence (A,C,G,T->0..3, other->4)."""
    n = len(codes)
    if n < k:
        return Minimizers(
            np.zeros(0, np.int32), np.zeros(0, np.uint32), np.zeros(0, np.int8)
        )
    if n - k + 1 >= w and (n - k + 1) - w + 1 > _TILE_WINDOWS:
        return _extract_tiled(codes, k, w)
    fwd, rc, valid = _kmer_values(codes, k)

    canonical = np.minimum(fwd, rc)
    strand = (rc < fwd).astype(np.int8)
    hashes = _mix32(canonical)
    # Invalidate N-containing and strand-ambiguous (palindromic) k-mers.
    hashes = np.where(valid & (fwd != rc), hashes, _INVALID)

    n_kmers = len(hashes)
    if n_kmers < w:
        w = n_kmers
    pos = np.unique(_window_argmin(hashes, w))
    pos = pos[hashes[pos] != _INVALID]
    return Minimizers(
        pos=pos.astype(np.int32),
        hash=hashes[pos],
        strand=strand[pos],
    )
