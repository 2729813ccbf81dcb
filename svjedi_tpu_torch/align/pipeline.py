"""Alignment pipeline: seeds → bucketed DP batches → winners → allele counts.

PyTorch counterpart of ``svjedi_tpu/align/pipeline.py`` on one
``torch.device``. Candidates are scored by one of three engines
(``align/device.py``), chosen as the JAX package chooses (:func:`resolve_engine`):
``gather`` on the CPU (the one-pass ``band_dp_batch``), ``v3`` on a CUDA
device (the two-pass v3 kernel: forward pass on every candidate, reverse pass
on the winners), or ``dma`` when named (the one-pass fused-fetch kernel).
The minimizer scan runs on the device where the JAX package runs it there
(:func:`use_device_scan`: ``align/dev_scan.py``, the CUDA kernel on a card,
its plain version on the CPU), and on the host otherwise; lookup, chaining
and the decoy competition run on the host, in this package's copies of the
JAX package's host modules.

The numpy-only helpers are verbatim copies of the JAX module's (that module
imports JAX, so they cannot be imported from it); each names its source and
``tests/test_torch_align.py`` holds each copy to the original. Where the
port has its own version of such a helper, that version replaces the copy,
and the tests hold it to the JAX function it reproduces: the chunk loop
elects winners in numpy rounds (:func:`elect`, in :func:`finalize_chunk`,
:func:`prune_secondaries` and :func:`cross_cluster_prune`), counts with
:func:`count_support_flat` and audits with :func:`compute_winner_stats` on
the chunk's resident buffers.
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig, GenotypeConfig
from ..graph.cluster import Panel
from ..io.fastq import ReadSet
from ..utils.spans import add, span
from .compete import suppress_merged
from .extend import DPParams
from .index import PanelIndex
from .seed import Candidates, ChainParams, seed_candidates

# Copied verbatim from svjedi_tpu/align/pipeline.py:Winners.
@dataclass
class Winners:
    """Winning alignment per (read, cluster), flat arrays."""

    read: np.ndarray
    cluster: np.ndarray
    path: np.ndarray
    strand: np.ndarray
    score: np.ndarray
    #: Alignment span: read coords are in the *oriented* read (reverse-
    #: complemented for strand 1); target coords are trimmed path coords.
    qs: np.ndarray
    qe: np.ndarray
    ts: np.ndarray
    te: np.ndarray
    #: Audit statistics (filled by :func:`compute_winner_stats` when audit
    #: collection is on): exact base matches and alignment block length
    #: (M+X+I+D) of the winning alignment, and a mapping-quality estimate.
    matches: Optional[np.ndarray] = None
    blocklen: Optional[np.ndarray] = None
    mapq: Optional[np.ndarray] = None
    #: Audit-pass invariant: how far the summed piece re-scores fall below
    #: the winning chain score (0 for healthy winners), and the flag for
    #: winners beyond the tolerated slack. Expected for breakpoint-crossing
    #: spans whose true alignment path steps off the interpolated diagonal
    #: by more than the doubled audit band (large net indels inside the
    #: span): the chain bridges a discontinuity minigraph would report as a
    #: split alignment, and the re-scored identity honestly reflects the
    #: unmatched middle. See the warning in :func:`compute_winner_stats`
    #: and tests/test_end_to_end.py's pinned count on the golden bundle.
    rescore_deficit: Optional[np.ndarray] = None
    rescore_flag: Optional[np.ndarray] = None
    #: Chain-anchor alignment span in path coordinates (outermost anchor
    #: extents; the analog of what a chain-level mapper like minigraph
    #: reports as Ts/Te). Set by finalize_chunk; chunk-local diagnostics.
    anchor_ts: Optional[np.ndarray] = None
    anchor_te: Optional[np.ndarray] = None

# Copied verbatim from svjedi_tpu/align/pipeline.py:_malloc_trim.
def _malloc_trim() -> None:
    """Return freed glibc heap to the OS (no-op where unavailable).

    The per-chunk seed/chain path mallocs and frees GB-scale scratch
    (anchor arrays, chain tables) from two threads; glibc retains much of
    it in per-thread arenas, so resident memory during a genome-scale
    align run reads far above live data. One malloc_trim(0) per flush
    (~1 ms) keeps RSS honest at Gb scale. Disable with SVJT_MALLOC_TRIM=0.
    """
    if os.environ.get("SVJT_MALLOC_TRIM", "1") == "0":
        return
    global _LIBC
    if _LIBC is None:
        try:
            import ctypes

            _LIBC = ctypes.CDLL("libc.so.6")
        except Exception:
            _LIBC = False
    if _LIBC:
        try:
            _LIBC.malloc_trim(0)
        except Exception:
            pass

_LIBC = None

# Copied verbatim from svjedi_tpu/align/pipeline.py:revcomp_codes.
def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    rc = codes[::-1].copy()
    mask = rc < 4
    rc[mask] = 3 - rc[mask]
    return rc

# Copied verbatim from svjedi_tpu/align/pipeline.py:_pick_bucket.
def _pick_bucket(m: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if m <= b:
            return b
    return buckets[-1]

# Copied verbatim from svjedi_tpu/align/pipeline.py:candidate_windows.
def candidate_windows(
    reads: ReadSet,
    index: PanelIndex,
    cands: Candidates,
    cfg: AlignConfig,
):
    """Per-block read-window bounds + junction-reachability prune.

    Returns (rw_start, rw_end, m, keep): the oriented-read window [rw_start,
    rw_end) each chain block aligns from (the block's [q_lo, q_hi) clipped
    to where the path is reachable around the block diagonal), its length
    m, and the keep mask.

    The prune: a (read, cluster) whose target coverage cannot put d_over
    bases on both sides of any junction of any of its paths can never
    contribute a count — reads confined to shared flanks are dropped as a
    group. The test is necessary-only (first/last junction bounds + band
    slop), so no countable alignment is ever dropped.
    """
    B = cfg.band
    slack = 2 * cfg.diag_bin
    rlen = reads.lengths
    path_len = index.path_len[cands.path]
    cand_rlen = rlen[cands.read]
    rw_start = np.clip(
        np.maximum(
            cands.q_lo.astype(np.int64),
            -cands.d0.astype(np.int64) - B // 2 - slack,
        ),
        0,
        cand_rlen,
    )
    rw_end = np.clip(
        np.minimum(
            cands.q_hi.astype(np.int64),
            path_len.astype(np.int64) - cands.d0 + B // 2 + slack,
        ),
        0,
        cand_rlen,
    )
    rw_end = np.maximum(rw_end, rw_start)
    m = (rw_end - rw_start).astype(np.int64)
    keep = m >= index.k

    d_over = 100
    margin = B // 2 + cfg.diag_bin
    t_lo = cands.d0.astype(np.int64) + rw_start - margin
    t_hi = cands.d0.astype(np.int64) + rw_end + margin
    possible = (
        (t_lo <= index.path_last_j[cands.path] - d_over)
        & (t_hi >= index.path_first_j[cands.path] + d_over)
    )
    if len(cands):
        cluster_key = (
            cands.read.astype(np.int64) * (int(index.path_cluster.max()) + 1)
            + index.path_cluster[cands.path]
        )
        order_k = np.argsort(cluster_key, kind="stable")
        ck_sorted = cluster_key[order_k]
        group_start = np.ones(len(ck_sorted), dtype=bool)
        group_start[1:] = ck_sorted[1:] != ck_sorted[:-1]
        group_ids = np.cumsum(group_start) - 1
        any_possible = np.zeros(group_ids[-1] + 1, bool)
        np.logical_or.at(any_possible, group_ids, possible[order_k])
        keep[order_k] &= any_possible[group_ids]
    return rw_start, rw_end, m, keep


# Copied verbatim from svjedi_tpu/align/pipeline.py:build_problem_batches.
def build_problem_batches(
    reads: ReadSet,
    panel: Panel,
    index: PanelIndex,
    cands: Candidates,
    cfg: AlignConfig,
    batch_size: int = 512,
):
    """Yield fixed-shape DP problem batches for a candidate set.

    Host-materialized variant (tests/debug); the production path gathers
    windows on device (align/device.py). Yields ``(chunk_indices, q_batch,
    t_batch, t_starts, rw_start_chunk)`` per batch, grouped by bucket.
    """
    B = cfg.band
    path_len = index.path_len[cands.path]
    rw_start, rw_end, m, keep = candidate_windows(reads, index, cands, cfg)
    order = np.flatnonzero(keep)
    bucket_of = np.array(
        [_pick_bucket(int(v), cfg.buckets) for v in m[order]], dtype=np.int64
    )

    rc_cache: Dict[int, np.ndarray] = {}

    def oriented_read(read_id: int, strand: int) -> np.ndarray:
        if strand == 0:
            return reads.seq(read_id)
        if read_id not in rc_cache:
            rc_cache[read_id] = revcomp_codes(reads.seq(read_id))
        return rc_cache[read_id]

    for bucket in sorted(set(bucket_of.tolist())):
        sel = order[bucket_of == bucket]
        for lo in range(0, len(sel), batch_size):
            chunk = sel[lo : lo + batch_size]
            P = len(chunk)
            q_batch = np.full((P, bucket), 4, dtype=np.int8)
            t_batch = np.full((P, bucket + B), 4, dtype=np.int8)
            t_starts = np.zeros(P, dtype=np.int64)
            for row, ci in enumerate(chunk):
                read_id = int(cands.read[ci])
                strand = int(cands.strand[ci])
                a, b = int(rw_start[ci]), int(rw_end[ci])
                window = oriented_read(read_id, strand)[a:b]
                q_batch[row, : len(window)] = window
                # Target window so that band cell (i, k) ↔ path position
                # t_start + i + k with t_start = (d0 + a) - B/2.
                t_start = int(cands.d0[ci]) + a - B // 2
                t_starts[row] = t_start
                pl = int(path_len[ci])
                src_lo = max(0, t_start)
                src_hi = min(pl, t_start + bucket + B)
                if src_hi > src_lo:
                    dst_lo = src_lo - t_start
                    seq = panel.paths[int(cands.path[ci])].seq
                    t_batch[row, dst_lo : dst_lo + (src_hi - src_lo)] = seq[
                        src_lo:src_hi
                    ]
            yield chunk, q_batch, t_batch, t_starts, rw_start[chunk]


def _round_up_128(P: int) -> int:
    """Batch width: P rounded up to whole 128-problem row-bound groups.

    The CUDA kernel does not specialise on P, so no power-of-two class is
    needed (the JAX engine pads to limit Mosaic compiles)."""
    return max(128, -(-P // 128) * 128)


def _dp_params(cfg: AlignConfig) -> DPParams:
    return DPParams(
        match=cfg.match,
        mismatch=cfg.mismatch,
        gap_open=cfg.gap_open,
        gap_extend=cfg.gap_extend,
    )


@dataclass
class ChunkDispatch:
    """DP results for one read chunk, still resident on the device.

    Results from many chunks are fetched together (:func:`collect_outs`,
    one copy per device) instead of one small copy per batch.

    The v3 engine is two-pass (kernels/band_dp_v3.py): the forward pass
    returns (score, qe, te) for every candidate; start coordinates come
    from a reverse pass dispatched only for the winning candidates
    (:func:`dispatch_rev`), so the per-candidate window metadata is kept
    here between the passes. The one-pass engines return starts too.
    """

    cands: Candidates
    rw_start: np.ndarray
    #: per batch: (candidate indices, device results, kind, bucket) where
    #: kind is "full" ((Ppad, 5) [score,qs,ts,qe,te]) or "v3"
    #: ((Ppad, 3) [score,qe,te], needs the reverse pass for qs/ts)
    batches: List[Tuple[np.ndarray, object, str, int]] = field(
        default_factory=list
    )
    #: per-candidate device-layout metadata (set by dispatch_chunk)
    q_start: Optional[np.ndarray] = None
    t_start: Optional[np.ndarray] = None
    t_lo: Optional[np.ndarray] = None
    t_hi: Optional[np.ndarray] = None
    bucket_of_cand: Optional[np.ndarray] = None
    device_data: Optional[object] = None
    #: window-coordinate ends per candidate (set by finalize_chunk)
    qe_win: Optional[np.ndarray] = None
    te_win: Optional[np.ndarray] = None
    #: reverse-pass batches: (winner positions, candidate indices, out)
    rev_batches: List[Tuple[np.ndarray, np.ndarray, object]] = field(
        default_factory=list
    )
    #: per-block forward scores (set by finalize_chunk; the reverse-pass
    #: invariant check compares against the first block's own score)
    block_score: Optional[np.ndarray] = None
    #: work handed to the device: the forward pass's kept windows and their
    #: rows, Σ m (set by dispatch_chunk); the reverse pass's winners without
    #: a start and their rows, Σ (qe + 1) (set by dispatch_rev); of those
    #: rows, the ones on panel paths that own an INV or BND link
    dp_problems: int = 0
    dp_rows: int = 0
    rev_problems: int = 0
    rev_rows: int = 0
    dp_rows_inv_bnd: int = 0
    rev_rows_inv_bnd: int = 0
    #: the primary set's election (set by finalize_chunk): alive chains
    #: elected and the election's rounds
    elect_rows: int = 0
    elect_rounds: int = 0
    #: per panel path, whether it owns an INV or BND link
    #: (:attr:`CountTable.path_inv_bnd`, set by dispatch_chunk)
    path_inv_bnd: Optional[np.ndarray] = None


# Copied verbatim from svjedi_tpu/align/pipeline.py:candidate_layout.
def candidate_layout(
    reads: ReadSet,
    index: PanelIndex,
    cands: Candidates,
    cfg: AlignConfig,
    device_data,
):
    """Per-candidate device-window metadata (align/device.py invariants).

    Returns (rw_start, m32, keep, q_start, t_start, t_lo, t_hi): the
    oriented-read window start, window length, junction-reachability keep
    mask, and the META_ROWS coordinates into the uploaded device layout.
    Reverse-strand windows address the rc half with positive stride. Shared
    by the chunk dispatcher and the on-mesh count step (dist/engine.py).
    """
    B = cfg.band
    rw_start, rw_end, m, keep = candidate_windows(reads, index, cands, cfg)
    N = device_data.n_bases
    read_off = reads.offsets[cands.read]
    read_end = reads.offsets[cands.read + 1]
    q_start = np.where(
        cands.strand == 0,
        read_off + rw_start,
        N + (N - read_end) + rw_start,
    ).astype(np.int32)
    t_start_rel = cands.d0.astype(np.int64) + rw_start - B // 2
    path_start = device_data.panel_start[cands.path]
    t_start = (path_start + t_start_rel).astype(np.int32)
    t_lo = path_start.astype(np.int32)
    t_hi = (path_start + device_data.panel_len[cands.path]).astype(np.int32)
    return rw_start, m.astype(np.int32), keep, q_start, t_start, t_lo, t_hi


#: The DP engines :func:`dispatch_chunk` runs.
ENGINES = ("gather", "dma", "v3")


def resolve_engine(engine: Optional[str], device: torch.device) -> str:
    """``engine``, or the JAX package's choice where it is None: ``gather``
    on the CPU, ``v3`` on any other device
    (``svjedi_tpu/align/pipeline.py:355``)."""
    if engine is None:
        return "gather" if device.type == "cpu" else "v3"
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return engine


def dispatch_chunk(
    reads: ReadSet,
    panel: Panel,
    index: PanelIndex,
    cands: Candidates,
    cfg: AlignConfig,
    device_data,
    batch_size: int = 32768,
    engine: Optional[str] = None,
) -> ChunkDispatch:
    """Enqueue all DP batches for one chunk; results stay on device.

    Every batch's ``[n_valid, row bounds, meta]`` block goes to the device
    in one copy; same-bucket batches merge up to ``batch_size`` problems per
    launch. ``engine`` (see :func:`resolve_engine`) decides the batch kind:
    "full" for the one-pass engines, "v3" for the v3 forward pass.
    """
    from . import device as dev

    B = cfg.band
    params = _dp_params(cfg)
    engine = resolve_engine(engine, dev.device_of(device_data))
    disp = ChunkDispatch(
        cands=cands, rw_start=np.zeros(len(cands), dtype=np.int64),
        device_data=device_data,
    )
    if len(cands) == 0:
        return disp

    rw_start, m32, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
        reads, index, cands, cfg, device_data
    )
    disp.rw_start = rw_start
    order = np.flatnonzero(keep)
    disp.dp_problems = len(order)
    disp.dp_rows = int(m32[order].sum(dtype=np.int64))
    disp.path_inv_bnd = count_table(panel).path_inv_bnd
    disp.dp_rows_inv_bnd = int(m32[order][
        disp.path_inv_bnd[cands.path[order]]].sum(dtype=np.int64))
    bucket_of = np.array(
        [_pick_bucket(int(v), cfg.buckets) for v in m32[order]],
        dtype=np.int64,
    )

    disp.q_start = q_start
    disp.t_start = t_start
    disp.t_lo = t_lo
    disp.t_hi = t_hi
    disp.bucket_of_cand = np.zeros(len(cands), dtype=np.int64)
    disp.bucket_of_cand[order] = bucket_of

    plans = []
    blocks = []
    off = 0
    for bucket in sorted(set(bucket_of.tolist())):
        sel_all = order[bucket_of == bucket]
        # Sort by window length: each 128-problem group then runs only
        # ceil(max m in group) rows (the v3 per-group row bound) instead of
        # the full bucket, and a one-pass kernel block holds similar lengths.
        sel_all = sel_all[np.argsort(m32[sel_all], kind="stable")]
        for lo in range(0, len(sel_all), batch_size):
            sel = sel_all[lo : lo + batch_size]
            P = len(sel)
            Ppad = _round_up_128(P)
            meta = np.zeros((5, Ppad), dtype=np.int32)
            meta[0, :P] = q_start[sel]
            meta[1, :P] = m32[sel]  # padding rows: m=0 → empty problems
            meta[2, :P] = t_start[sel]
            meta[3, :P] = t_lo[sel]
            meta[4, :P] = t_hi[sel]
            blocks.append(dev.flat_meta_block(meta, P))
            plans.append((sel, off, Ppad, int(bucket)))
            off += dev.flat_block_len(Ppad)
    flat = dev.upload_flat_meta(blocks, device=dev.device_of(device_data))
    for sel, off_b, Ppad, bucket in plans:
        if engine == "v3":
            out = dev.window_score_v3_fwd_flat(
                device_data, flat, off_b, Ppad, bucket, band=B, params=params,
            )
        else:
            out = dev.window_score_packed_flat(
                device_data, flat, off_b, Ppad, bucket, band=B, params=params,
                engine=engine,
            )
        disp.batches.append((sel, out, "v3" if engine == "v3" else "full", bucket))
    return disp


def _bulk_fetch(outs: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Fetch many device tensors with ONE device→host copy per device."""
    if not outs:
        return []
    by_dev: Dict[torch.device, List[int]] = {}
    for i, o in enumerate(outs):
        by_dev.setdefault(o.device, []).append(i)
    res: List[Optional[np.ndarray]] = [None] * len(outs)
    for idxs in by_dev.values():
        flats = [outs[i].reshape(-1) for i in idxs]
        host = (flats[0] if len(flats) == 1 else torch.cat(flats)).cpu().numpy()
        off = 0
        for i in idxs:
            size = outs[i].numel()
            res[i] = host[off : off + size].reshape(tuple(outs[i].shape))
            off += size
    return res


def collect_outs(dispatches: Sequence[ChunkDispatch]) -> List[List[np.ndarray]]:
    """Fetch every pending batch result with one device→host copy."""
    hosts = _bulk_fetch(
        [out for d in dispatches for (_, out, _, _) in d.batches]
    )
    per: List[List[np.ndarray]] = []
    it = iter(hosts)
    for d in dispatches:
        per.append([next(it) for _ in d.batches])
    return per


# Copied verbatim from svjedi_tpu/align/pipeline.py:compute_mapq.
def compute_mapq(
    score: np.ndarray,
    s2: np.ndarray,
    support: np.ndarray,
    dec_other: np.ndarray,
    dec_same: np.ndarray,
) -> np.ndarray:
    """minimap2-style mapping quality from the aligner's own margins.

    Replaces the round-2 constant-60 placeholder (GAF col 12 semantics,
    filter-alignments.py:184-198). Two independent ambiguity sources, each
    a [0, 1] confidence factor; the final mapq takes the weaker one:

    - ``s2/score``: best SAME-PATH chain rejected for >=50% read-interval
      overlap with this winner (a repeat-shifted alternative placement on
      the same haplotype sequence; minimap2's f2/f1 term).
    - ``dec_other / max(dec_same, support)``: the whole-genome decoy
      competition's margin — the strongest elsewhere-in-the-genome
      explanation of these read bases vs the strongest at-locus evidence
      (decoy.suppress_candidates; survivors have ratio <= 1, ties -> 0).

    Scaled by min(1, support/10) (thin-anchor chains cap out lower, the
    minimap2 mlen/10 term), to the conventional [0, 60] range.
    """
    n = len(score)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    s1 = np.maximum(score.astype(np.float64), 1.0)
    f_rep = 1.0 - s2.astype(np.float64) / s1
    denom = np.maximum(np.maximum(dec_same, support), 1).astype(np.float64)
    f_dec = 1.0 - dec_other.astype(np.float64) / denom
    f = np.clip(np.minimum(f_rep, f_dec), 0.0, 1.0)
    f *= np.minimum(1.0, support.astype(np.float64) / 10.0)
    return np.clip(np.floor(60.0 * f + 0.5), 0, 60).astype(np.int64)


def elect(group: np.ndarray, lo: np.ndarray, hi: np.ndarray,
          eligible: Optional[np.ndarray] = None,
          cap: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """One greedy mask_level election (minimap2's rule) over rows given in
    the order the greedy loop visits them, ``group`` nondecreasing.

    A visited row is kept unless a row already kept in its group covers at
    least half of its own span: on half-open ``[lo, hi)``, with ``ov =
    min(hi, hi_k) - max(lo, lo_k)`` and ``span = max(1, hi - lo)``, the rule
    ``ov >= 0.5 * span`` is ``2 * ov >= span`` in integers. Rows outside
    ``eligible`` are not visited. With ``cap``, a group stops at its
    ``cap``-th kept row: its later rows are not visited.

    Returns ``(keep, blocker, rounds)``: ``keep`` per row; ``blocker`` per
    visited, rejected row the index of the first kept row of its group, in
    kept order, that masks it, and -1 elsewhere; and the numpy rounds
    taken. Each round keeps the first undecided row of every group (the
    rounds before tested it against every row kept so far) and rejects
    the undecided rows of the group that it masks. So there are as many
    rounds as the most rows a group keeps, each round's work is the rows
    still undecided, and the result is the sequential loop's.
    """
    n = len(group)
    keep = np.zeros(n, dtype=bool)
    blocker = np.full(n, -1, dtype=np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    span = np.maximum(1, hi - lo)
    live = np.arange(n) if eligible is None else np.flatnonzero(eligible)
    rounds = 0
    while len(live):
        rounds += 1
        g = group[live]
        head = np.ones(len(live), dtype=bool)
        head[1:] = g[1:] != g[:-1]
        heads = live[head]
        lead = heads[np.cumsum(head) - 1]
        keep[heads] = True
        ov = np.minimum(hi[live], hi[lead]) - np.maximum(lo[live], lo[lead])
        masked = (2 * ov >= span[live]) & ~head
        blocker[live[masked]] = lead[masked]
        live = live[~(masked | head)]
        if rounds == cap:
            # Each group left holds cap kept rows, the last of them in
            # ``heads``: the rows after it were never visited.
            ends = np.searchsorted(group, group[heads], side="right")
            after = np.zeros(n + 1, dtype=np.int64)
            np.add.at(after, heads + 1, 1)
            np.add.at(after, ends, -1)
            blocker[np.cumsum(after[:n]) > 0] = -1
            break
    return keep, blocker, rounds


def _keep_winners(winners: Winners, keep: np.ndarray) -> Winners:
    """``winners``' rows where ``keep`` holds (``winners`` itself where it
    holds everywhere), the optional fields that are set included."""
    if keep.all():
        return winners
    out = Winners(
        *[
            getattr(winners, f)[keep]
            for f in (
                "read", "cluster", "path", "strand", "score",
                "qs", "qe", "ts", "te",
            )
        ]
    )
    for f in ("matches", "blocklen", "mapq", "anchor_ts", "anchor_te",
              "rescore_deficit", "rescore_flag"):
        v = getattr(winners, f)
        if v is not None:
            setattr(out, f, v[keep])
    return out


# The rules of svjedi_tpu/align/pipeline.py:finalize_chunk, the primary set
# elected by :func:`elect`.
def finalize_chunk(
    reads: ReadSet,
    index: PanelIndex,
    cfg: AlignConfig,
    disp: ChunkDispatch,
    host_rows: Sequence[np.ndarray],
) -> Tuple[Winners, np.ndarray]:
    """Chain aggregation + primary-set reduction per (read, cluster).

    Block results are aggregated per chain: the chain score is the sum of
    its blocks scoring >= ``min_score`` (a per-block noise floor — a random
    1536x128 window peaks around ~25, so summing unfloored blocks would
    manufacture chain scores), the chain end comes from its last scoring
    block, and the start from the reverse pass on the FIRST scoring block
    (returned via ``win``). For chains scored by the v3 forward pass,
    qs/ts are left as -1 until :func:`patch_rev`.

    Reduction keeps a PRIMARY SET per (read, cluster), not a single
    winner: panel paths are local haplotype fragments (walks stop at
    foreign clusters' links), so a read spanning several junction locales
    of one cluster has several disjoint fragment alignments — the
    reference counts every edge its ONE whole-graph alignment crosses, so
    each fragment must count. Chains are kept greedily by score when
    their forward-read intervals overlap every kept chain by < 50% of
    their own length (minimap2's mask_level rule); ref-vs-alt branch
    competition at one junction is preserved because those alignments
    cover the same read interval.
    """
    cands = disp.cands
    B = cfg.band
    n = len(cands)
    empty = np.zeros(0, np.int64)
    if n == 0:
        return Winners(*([empty] * 9)), empty
    out_score = np.zeros(n, dtype=np.int64)
    out_qs = np.full(n, -1, dtype=np.int64)
    out_qe = np.full(n, -1, dtype=np.int64)
    out_ts = np.full(n, -1, dtype=np.int64)
    out_te = np.full(n, -1, dtype=np.int64)
    disp.qe_win = np.full(n, -1, dtype=np.int64)
    disp.te_win = np.full(n, -1, dtype=np.int64)

    for (sel, _, kind, _), host in zip(disp.batches, host_rows):
        P = len(sel)
        res = host[:P].astype(np.int64)
        t_starts = (
            cands.d0[sel].astype(np.int64) + disp.rw_start[sel] - B // 2
        )
        out_score[sel] = res[:, 0]
        if kind == "v3":
            disp.qe_win[sel] = res[:, 1]
            disp.te_win[sel] = res[:, 2]
            out_qe[sel] = res[:, 1] + disp.rw_start[sel]
            out_te[sel] = res[:, 2] + t_starts
        else:
            out_qs[sel] = res[:, 1] + disp.rw_start[sel]
            out_qe[sel] = res[:, 3] + disp.rw_start[sel]
            out_ts[sel] = res[:, 2] + t_starts
            out_te[sel] = res[:, 4] + t_starts

    disp.block_score = out_score

    # ---- aggregate blocks into chains via CONNECTED RUNS ----
    # A chain's alignment is its best maximal run of consecutive good
    # blocks where each block's alignment END (in path coords) reaches the
    # next block's window start: a weak spurious block far from the real
    # alignment (an extension block picking up a 20-base repeat) must not
    # stretch the reported span across unaligned territory — the
    # reference's Ts..Te always belongs to ONE contiguous alignment.
    uniq_chain, inv = np.unique(cands.chain, return_inverse=True)
    n_chains = len(uniq_chain)
    good = out_score >= cfg.min_score
    good_idx = np.flatnonzero(good)
    if len(good_idx) == 0:
        return Winners(*([empty] * 9)), empty
    connect_slack = cfg.band + 2 * cfg.diag_bin + 128
    next_start = cands.d0.astype(np.int64) + disp.rw_start
    connected = np.zeros(n, dtype=bool)
    if n > 1:
        connected[1:] = (
            good[1:]
            & good[:-1]
            & (cands.chain[1:] == cands.chain[:-1])
            & (out_te[:-1] >= next_start[1:] - connect_slack)
        )
    run_id = np.cumsum(~connected)  # consecutive connected rows share a run
    n_runs = int(run_id[-1]) + 1
    run_score = np.zeros(n_runs, dtype=np.int64)
    np.add.at(run_score, run_id[good_idx], out_score[good_idx])
    run_first = np.full(n_runs, n, dtype=np.int64)
    np.minimum.at(run_first, run_id[good_idx], good_idx)
    run_last = np.full(n_runs, -1, dtype=np.int64)
    np.maximum.at(run_last, run_id[good_idx], good_idx)
    # best run per chain (ties -> lowest run id)
    live_runs = np.flatnonzero(run_last >= 0)
    run_chain = inv[run_first[live_runs]]
    chain_score = np.zeros(n_chains, dtype=np.int64)
    np.maximum.at(chain_score, run_chain, run_score[live_runs])
    is_best = run_score[live_runs] == chain_score[run_chain]
    best_run = np.full(n_chains, n_runs, dtype=np.int64)
    np.minimum.at(best_run, run_chain[is_best], live_runs[is_best])
    has_run = best_run < n_runs
    first_blk = np.full(n_chains, n, dtype=np.int64)
    last_blk = np.full(n_chains, -1, dtype=np.int64)
    first_blk[has_run] = run_first[best_run[has_run]]
    last_blk[has_run] = run_last[best_run[has_run]]
    alive = np.flatnonzero((chain_score >= cfg.min_score) & (last_blk >= 0))
    if len(alive) == 0:
        return Winners(*([empty] * 9)), empty

    # ---- primary set per (read, cluster) among alive chains ----
    # Chain read intervals use the ANCHOR extents (forward read coords):
    # block bounds are quantized to block_rows and inflated by extension
    # blocks, which would blur the 50%-overlap primary selection.
    rep = first_blk[alive]  # representative block per chain
    cluster_all = index.path_cluster[cands.path].astype(np.int64)
    a_read = cands.read[rep].astype(np.int64)
    a_strand = cands.strand[rep].astype(np.int64)
    a_rlen = reads.lengths[cands.read[rep]].astype(np.int64)
    c_alo = cands.a_lo[rep].astype(np.int64)
    c_ahi = cands.a_hi[rep].astype(np.int64)
    a_qlo = np.where(a_strand == 0, c_alo, a_rlen - c_ahi)
    a_qhi = np.where(a_strand == 0, c_ahi, a_rlen - c_alo)
    key = a_read * (cluster_all.max() + 1) + cluster_all[rep]
    a_path = cands.path[rep].astype(np.int64)
    order2 = np.lexsort((alive, -chain_score[alive], key))
    # A rejected row raises s2 of the first kept chain that masks it where
    # both lie on the same path: the best SAME-PATH challenger rejected for
    # >=50% read-interval overlap (repeat-shifted placement on the same
    # haplotype sequence). Cross-path overlap rejections are allele
    # competition — the graph aligner resolves those at full confidence
    # (minigraph maps against the whole graph and reports one path), so
    # they must NOT depress mapq. A group stops at MAX_PRIMARY kept chains.
    MAX_PRIMARY = 8
    keep, blocker, rounds = elect(
        key[order2], a_qlo[order2], a_qhi[order2], cap=MAX_PRIMARY
    )
    disp.elect_rows = len(order2)
    disp.elect_rounds = rounds
    kept_rows = order2[keep]
    kept_s2 = np.zeros(len(kept_rows), dtype=np.int64)
    rej = np.flatnonzero(blocker >= 0)
    rej = rej[a_path[order2[rej]] == a_path[order2[blocker[rej]]]]
    np.maximum.at(kept_s2, (np.cumsum(keep) - 1)[blocker[rej]],
                  chain_score[alive[order2[rej]]])
    win_chain = alive[kept_rows]

    win = first_blk[win_chain]
    last = last_blk[win_chain]
    winners = Winners(
        read=cands.read[win].astype(np.int64),
        cluster=cluster_all[win],
        path=cands.path[win].astype(np.int64),
        strand=cands.strand[win].astype(np.int64),
        score=chain_score[win_chain],
        qs=out_qs[win],
        qe=out_qe[last],
        ts=out_ts[win],
        te=out_te[last],
        anchor_ts=cands.a_lo[win].astype(np.int64)
        + cands.d0[win].astype(np.int64),
        anchor_te=cands.a_hi[last].astype(np.int64) - 1
        + cands.d0[last].astype(np.int64),
    )
    winners.mapq = compute_mapq(
        score=chain_score[win_chain],
        s2=kept_s2,
        support=cands.n_anchors[win].astype(np.int64),
        dec_other=cands.dec_other[win].astype(np.int64),
        dec_same=cands.dec_same[win].astype(np.int64),
    )
    return winners, win


def dispatch_rev(
    cfg: AlignConfig,
    disp: ChunkDispatch,
    winners: Winners,
    win: np.ndarray,
) -> None:
    """Enqueue the v3 reverse pass for winning candidates missing qs/ts.

    The windows are end-clamped (m' = qe+1, t_hi' = t_start + te + 1) so
    the reverse-pass best end is the start of an optimal alignment ending
    at most at (qe, te).
    """
    from . import device as dev

    if len(win) == 0 or disp.q_start is None:
        return
    params = _dp_params(cfg)
    need = np.flatnonzero(winners.qs == -1)
    if len(need) == 0:
        return
    ci = win[need]
    disp.rev_problems = len(need)
    disp.rev_rows = int((disp.qe_win[ci] + 1).sum(dtype=np.int64))
    on = disp.path_inv_bnd[disp.cands.path[ci]]
    disp.rev_rows_inv_bnd = int((disp.qe_win[ci][on] + 1).sum(dtype=np.int64))
    # Rebucket by the CLAMPED window length m' = qe+1 (the real aligned
    # span), not the forward bucket.
    buckets = np.array(
        [_pick_bucket(int(v), cfg.buckets) for v in disp.qe_win[ci] + 1],
        dtype=np.int64,
    )
    plans = []
    blocks = []
    off = 0
    for bucket in sorted(set(buckets.tolist())):
        sub = need[buckets == bucket]
        csub = win[sub]
        P = len(sub)
        Ppad = _round_up_128(P)
        meta = np.zeros((5, Ppad), dtype=np.int32)
        meta[0, :P] = disp.q_start[csub]
        meta[1, :P] = disp.qe_win[csub] + 1
        meta[2, :P] = disp.t_start[csub]
        meta[3, :P] = disp.t_lo[csub]
        meta[4, :P] = np.minimum(
            disp.t_hi[csub],
            disp.t_start[csub].astype(np.int64) + disp.te_win[csub] + 1,
        )
        # The reverse kernel takes its rows from each problem's m' (meta
        # row 1) and reads no row bound; the block keeps the JAX layout,
        # whose bounds are the whole bucket.
        blocks.append(
            dev.flat_meta_block(
                meta, P, row_bounds=np.full(Ppad // 128, bucket, np.int32),
            )
        )
        plans.append((sub, csub, off, Ppad, int(bucket)))
        off += dev.flat_block_len(Ppad)
    flat = dev.upload_flat_meta(
        blocks, device=dev.device_of(disp.device_data)
    )
    for sub, csub, off_b, Ppad, bucket in plans:
        out = dev.window_score_v3_rev_flat(
            disp.device_data, flat, off_b, Ppad, bucket, band=cfg.band,
            params=params,
        )
        disp.rev_batches.append((sub, csub, out))


def patch_rev(
    cfg: AlignConfig,
    disp: ChunkDispatch,
    winners: Winners,
    host_rows: Sequence[np.ndarray],
) -> None:
    """Fill winners' qs/ts from fetched reverse-pass results."""
    B = cfg.band
    for (sub, csub, _), host in zip(disp.rev_batches, host_rows):
        P = len(sub)
        res = host[:P].astype(np.int64)
        t_starts = (
            disp.cands.d0[csub].astype(np.int64)
            + disp.rw_start[csub]
            - B // 2
        )
        winners.qs[sub] = res[:, 1] + disp.rw_start[csub]
        winners.ts[sub] = res[:, 2] + t_starts
        bad = res[:, 0] != disp.block_score[csub]
        if bad.any():  # invariant check
            print(
                f"[align] WARNING: {int(bad.sum())} reverse-pass scores "
                "disagree with forward pass",
                file=sys.stderr,
            )


def collect_rev(dispatches: Sequence[ChunkDispatch]) -> List[List[np.ndarray]]:
    """Bulk-fetch all reverse-pass batches."""
    hosts = _bulk_fetch(
        [out for d in dispatches for (_, _, out) in d.rev_batches]
    )
    per: List[List[np.ndarray]] = []
    it = iter(hosts)
    for d in dispatches:
        per.append([next(it) for _ in d.rev_batches])
    return per


def align_candidates(
    reads: ReadSet,
    panel: Panel,
    index: PanelIndex,
    cands: Candidates,
    cfg: AlignConfig,
    batch_size: int = 32768,
    device_data=None,
    *,
    device: Optional[torch.device] = None,
) -> Winners:
    """Score all candidates and reduce to per-(read, cluster) winners.

    One chunk, no decoy, no audit, the default engine
    (``svjedi_tpu/align/pipeline.py:834``). Without ``device_data`` the
    reads and panel are uploaded to ``device`` (default ``cuda:0``, which
    raises where no card is visible).
    """
    from . import device as dev

    if device_data is None:
        if device is None:
            from ..pipeline import select_device

            device = select_device()
        device_data = dev.upload(reads.codes, panel, device)
    disp = dispatch_chunk(
        reads, panel, index, cands, cfg, device_data, batch_size=batch_size
    )
    (host_rows,) = collect_outs([disp])
    winners, win = finalize_chunk(reads, index, cfg, disp, host_rows)
    dispatch_rev(cfg, disp, winners, win)
    (rev_rows,) = collect_rev([disp])
    patch_rev(cfg, disp, winners, rev_rows)
    return prune_secondaries(winners, reads, cfg)


# The rules of svjedi_tpu/align/pipeline.py:prune_secondaries, the overlap
# prune elected by :func:`elect`.
def prune_secondaries(
    winners: Winners, reads: ReadSet, cfg: AlignConfig = None, *,
    timings: Optional[Dict] = None,
) -> Winners:
    """Score-density floor + secondary overlap prune (post-rev).

    Density: a counted alignment must score >= min_density_millis/1000
    per aligned base over the longer of its spans — connected runs of
    weak repeat matches (0.1-0.3 per base) are junk minigraph's own
    alignment scoring would never emit.

    Overlap: the pre-DP primary selection works on anchor extents, which
    underestimate alignment spans (repeat k-mers are dropped by the index
    hit cap, thinning anchors exactly where repeat-shifted junk lives), so
    a repeat-shifted secondary can slip past it. With the reverse pass
    done, real [qs..qe] spans exist — re-run the mask_level rule per
    (read, cluster) on them before counting, by score, the dense rows only.

    ``timings`` (a dict, or None) gains the rows elected (``elect_rows``),
    the election's rounds (``elect_rounds``) and the rows below the density
    floor (``density_dropped``).
    """
    n = len(winners.read)
    if n == 0:
        return winners
    rlen = reads.lengths[winners.read]
    q_lo = np.where(winners.strand == 0, winners.qs, rlen - 1 - winners.qe)
    q_hi = np.where(winners.strand == 0, winners.qe, rlen - 1 - winners.qs)
    key = winners.read * (winners.cluster.max() + 1) + winners.cluster
    order = np.lexsort((np.arange(n), -winners.score, key))
    dense = None
    if cfg is not None:
        span = np.maximum(
            winners.qe - winners.qs + 1, winners.te - winners.ts + 1
        )
        dense = (winners.score * 1000 >= cfg.min_density_millis * span)[order]
    # [lo, hi] closed is [lo, hi + 1) half-open: the same overlap and span.
    keep_s, _, rounds = elect(key[order], q_lo[order], q_hi[order] + 1,
                              eligible=dense)
    add(timings, "elect_rows", n)
    add(timings, "elect_rounds", rounds)
    add(timings, "density_dropped", 0 if dense is None else n - dense.sum())
    keep = np.zeros(n, dtype=bool)
    keep[order] = keep_s
    return _keep_winners(winners, keep)


# The rules of svjedi_tpu/align/pipeline.py:cross_cluster_prune, the
# read-level prune elected by :func:`elect`.
def cross_cluster_prune(winners: Winners, reads: ReadSet, *,
                        timings: Optional[Dict] = None) -> Winners:
    """Read-level primary selection across ALL clusters, density-ranked.

    minigraph picks one primary alignment per read segment over the whole
    graph; our per-(read, cluster) fragments compete only within their
    cluster, so a read claiming two distant loci with the SAME bases keeps
    both. Greedily keep fragments per read by score DENSITY (score/span —
    raw-score ranking favors long mediocre fragments; the density variant
    measured 25 -> 24 extra crossings with zero under-counts on the golden
    bundle, tools/parity_experiments.py) under the mask_level 0.5 overlap
    rule in forward-read coordinates. Fragments at different loci cover
    different read intervals and never mask each other.

    ``timings`` (a dict, or None) gains the rows elected (``elect_rows``)
    and the election's rounds (``elect_rounds``).
    """
    n = len(winners.read)
    if n == 0:
        return winners
    rlen = reads.lengths[winners.read]
    q_lo = np.where(winners.strand == 0, winners.qs, rlen - 1 - winners.qe)
    q_hi = np.where(winners.strand == 0, winners.qe, rlen - 1 - winners.qs)
    span = np.maximum(
        1,
        np.maximum(q_hi - q_lo + 1, winners.te - winners.ts + 1),
    )
    dens = winners.score / span
    order = np.lexsort((np.arange(n), -dens, winners.read))
    # [lo, hi] closed is [lo, hi + 1) half-open: the same overlap and span.
    keep_s, _, rounds = elect(winners.read[order], q_lo[order],
                              q_hi[order] + 1)
    add(timings, "elect_rows", n)
    add(timings, "elect_rounds", rounds)
    keep = np.zeros(n, dtype=bool)
    keep[order] = keep_s
    return _keep_winners(winners, keep)


def pick_buckets(m: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """:func:`_pick_bucket` of every element of ``m``: the first of the
    ascending ``buckets`` that holds it, else the last."""
    b = np.asarray(buckets, dtype=np.int64)
    return b[np.minimum(np.searchsorted(b, m, side="left"), len(b) - 1)]


def audit_piece_table(winners: Winners, block_rows: int, band: int):
    """The audit's pieces, winner by winner in read order: each winner's
    rows [qs, qe] cut into ``block_rows``-row pieces [a, b), and each
    piece's target window start t0, the span diagonal interpolated to row a
    less half the ``band``. Returns int64 (winner, a, b, t0) arrays; a
    winner with no rows has no piece. ``np.rint`` of the float64 quotient
    rounds half to even, as Python's ``round`` does, and every operand is
    far below 2^53, so the table equals a per-piece loop's."""
    qs = winners.qs.astype(np.int64)
    qe = winners.qe.astype(np.int64)
    ts = winners.ts.astype(np.int64)
    rows = qe - qs + 1
    tspan = winners.te.astype(np.int64) - ts + 1
    n_pieces = np.where(rows > 0, (rows + block_rows - 1) // block_rows, 0)
    p_win = np.repeat(np.arange(len(rows)), n_pieces)
    first = np.cumsum(n_pieces) - n_pieces
    off = (np.arange(len(p_win)) - first[p_win]) * block_rows
    p_a = qs[p_win] + off
    p_b = np.minimum(p_a + block_rows, qe[p_win] + 1)
    t_a = ts[p_win] + np.rint(
        off * tspan[p_win] / rows[p_win]).astype(np.int64)
    return p_win, p_a, p_b, t_a - band // 2


def _fused_pieces(reads: ReadSet, winners: Winners, device_data, p_win,
                  p_a, p_b, p_t0) -> np.ndarray:
    """The pieces' :data:`kernels.band_dp_stats.PIECE_ROWS` in the
    coordinates of ``device_data``, as :func:`candidate_layout` computes
    them: the oriented read's rows [a, b) in ``reads2`` (a reverse-strand
    read in the reverse-complement half), the target window from t0 on the
    winner's path in ``panel_padded``, valid in [max(ts, 0), min(te + 1,
    path length)), where the JAX package's host assembly clamps it."""
    from ..kernels.band_dp_stats import pack_pieces

    read = winners.read[p_win]
    path = winners.path[p_win]
    N = device_data.n_bases
    q_start = np.where(winners.strand[p_win] == 0,
                       reads.offsets[read] + p_a,
                       N + (N - reads.offsets[read + 1]) + p_a)
    path_start = device_data.panel_start[path]
    t_lo = path_start + np.maximum(winners.ts[p_win], 0)
    t_hi = path_start + np.minimum(winners.te[p_win] + 1,
                                   device_data.panel_len[path])
    return pack_pieces(q_start, path_start + p_t0, p_b - p_a, t_lo, t_hi)


def compute_winner_stats(
    reads: ReadSet,
    panel: Panel,
    winners: Winners,
    cfg: AlignConfig,
    device_data,
    timings: Optional[Dict] = None,
) -> None:
    """Fill ``winners.matches``/``blocklen`` by re-scoring winning spans.

    The audit pass: each winner's alignment rectangle [qs..qe] x [ts..te]
    is split into <= ``block_rows``-row pieces whose target windows follow
    the linearly-interpolated span diagonal, and each piece is re-run
    through the stats-tracking banded DP (band doubled to absorb residual
    drift). Summed piece stats give the exact-match count and block length
    the reference's GAF consumers expect (filter-alignments.py:193-196).

    The DP fetches each piece's windows itself from the chunk's resident
    ``reads2`` and ``panel_padded`` (``device_data``, the chunk's
    :class:`device.DeviceData`, on its device):
    :func:`kernels.band_dp_stats.band_dp_stats_flat`, A1 on a card, a
    gather and the plain version on the CPU. The host uploads five int32
    offsets a piece. Each bucket's pieces go to the DP in one call (the
    JAX package cuts them into slices of 4,096); the pieces are
    independent and the sums integer, so the batching changes no output.

    ``timings`` gains the seconds of the piece table, its offsets and the
    bucket pick (``audit_table_s``), of each bucket's offsets uploaded
    (``audit_assembly_s``) and of the DP calls up to their results on the
    host (``audit_dp_s``), and the pieces and their rows handed to the DP
    (``audit_pieces``, ``audit_rows``).
    """
    from ..kernels import band_dp_stats as a1
    from . import device as dev

    n = len(winners.read)
    winners.matches = np.zeros(n, dtype=np.int64)
    winners.blocklen = np.zeros(n, dtype=np.int64)
    if winners.mapq is None:
        winners.mapq = np.full(n, 60, dtype=np.int64)
    if n == 0:
        return
    B2 = 2 * cfg.band
    PIECE = cfg.block_rows
    params = _dp_params(cfg)
    qspan = (winners.qe - winners.qs + 1).astype(np.int64)
    tspan = (winners.te - winners.ts + 1).astype(np.int64)
    device = dev.device_of(device_data)

    # Piece table: (winner, piece q window [a, b), t window start).
    with span(timings, "audit_table_s", "align.audit.table"):
        p_win, p_a, p_b, p_t0 = audit_piece_table(winners, PIECE, B2)
        p_m = p_b - p_a
        order = np.argsort(p_m, kind="stable")
        bucket_of = pick_buckets(p_m[order], cfg.buckets)
        pieces = _fused_pieces(reads, winners, device_data, p_win, p_a, p_b,
                               p_t0)
    add(timings, "audit_pieces", len(p_m))
    add(timings, "audit_rows", p_m.sum())

    score_sum = np.zeros(n, dtype=np.int64)
    n_diag_sum = np.zeros(n, dtype=np.int64)
    for bucket in sorted(set(bucket_of.tolist())):
        sel = order[bucket_of == bucket]
        with span(timings, "audit_assembly_s", "align.audit.assembly"):
            cols = torch.from_numpy(
                np.ascontiguousarray(pieces[:, sel])).to(device)
        with span(timings, "audit_dp_s", "align.audit.dp"):
            out = a1.band_dp_stats_flat(
                device_data.reads2, device_data.panel_padded, cols, bucket,
                B2, params)
            host = torch.stack(
                [out["matches"], out["n_diag"], out["score"]]
            ).cpu().numpy().astype(np.int64)
        np.add.at(winners.matches, p_win[sel], host[0])
        np.add.at(n_diag_sum, p_win[sel], host[1])
        np.add.at(score_sum, p_win[sel], host[2])
    winners.blocklen[:] = np.maximum(qspan + tspan - n_diag_sum, 1)
    # Piece re-scores can deviate from the chain score in both directions
    # (piece cuts lose alignment continuity; the doubled band recovers
    # clipped segments); warn only when the sum falls far below.
    slack = 64 * np.maximum(1, (qspan + PIECE - 1) // PIECE)
    winners.rescore_deficit = np.maximum(0, winners.score - score_sum)
    winners.rescore_flag = score_sum + slack < winners.score
    mismatched = int(winners.rescore_flag.sum())
    if mismatched:  # invariant check
        print(
            f"[align] WARNING: {mismatched} audit re-scores fell well "
            "below the winning chain score",
            file=sys.stderr,
        )


#: SV types of the count table's tags (:attr:`CountTable.tag_kind` codes),
#: then the code of a tag of none of them.
SV_KINDS = ("DEL", "INS", "INV", "BND")
_KIND_OF_TAG = re.compile(r":(DEL|INS|INV|BND)-")


def tag_kind(tag: str) -> int:
    """The :data:`SV_KINDS` code of a count-table tag ``{chrom}:{sv_id}``
    (the type that begins its sv id), or ``len(SV_KINDS)``."""
    m = _KIND_OF_TAG.search(tag)
    return SV_KINDS.index(m.group(1)) if m else len(SV_KINDS)


@dataclass
class CountTable:
    """A panel's owned links, flattened once for :func:`count_support_flat`.

    Path ``p`` owns entries ``offsets[p]:offsets[p + 1]`` (its ``owned`` in
    walk order): tag id (into ``tag_names``), allele, junction offset and
    link index. ``head[p]`` is the audit line's oriented node walk and the
    path's untrimmed length, tab-joined; ``trim_left[p]`` rebases its
    target coordinates. ``tag_kind[t]`` is tag ``t``'s SV type
    (:func:`tag_kind`); ``path_inv_bnd[p]`` whether path ``p`` owns an INV
    or BND link, ``path_cross_chrom[p]`` whether its walk holds nodes of
    two chromosomes.
    """

    offsets: np.ndarray
    tag: np.ndarray
    allele: np.ndarray
    junction: np.ndarray
    link: np.ndarray
    tag_names: List[str]
    head: np.ndarray
    trim_left: np.ndarray
    tag_kind: np.ndarray
    path_inv_bnd: np.ndarray
    path_cross_chrom: np.ndarray


def count_table(panel: Panel) -> CountTable:
    """The panel's :class:`CountTable`, built on first use and kept on the
    panel, so a catalogue pays for it once."""
    table = panel.__dict__.get("_count_table")
    if table is None:
        table = _build_count_table(panel)
        panel._count_table = table
    return table


def _build_count_table(panel: Panel) -> CountTable:
    from ..graph.build import REV

    nodes = panel.graph.nodes
    tag_ids: Dict[str, int] = {}
    flat = np.array(
        [(tag_ids.setdefault(tag, len(tag_ids)), allele, j, li)
         for path in panel.paths for tag, allele, j, li in path.owned],
        dtype=np.int64,
    ).reshape(-1, 4)
    offsets = np.zeros(len(panel.paths) + 1, dtype=np.int64)
    np.cumsum([len(path.owned) for path in panel.paths], out=offsets[1:])
    head = np.empty(len(panel.paths), dtype=object)
    head[:] = [
        "".join(("<" if s == REV else ">") + nodes[n].name
                for (n, s) in path.states) + f"\t{path.full_len}"
        for path in panel.paths
    ]
    kinds = np.array([tag_kind(t) for t in tag_ids], dtype=np.int64)
    inv_bnd = np.isin(kinds[flat[:, 0]], [SV_KINDS.index("INV"),
                                          SV_KINDS.index("BND")])
    path_inv_bnd = np.zeros(len(panel.paths), dtype=bool)
    path_inv_bnd[np.repeat(np.arange(len(panel.paths)),
                           np.diff(offsets))[inv_bnd]] = True
    return CountTable(
        offsets=offsets, tag=flat[:, 0], allele=flat[:, 1],
        junction=flat[:, 2], link=flat[:, 3], tag_names=list(tag_ids),
        head=head,
        trim_left=np.array([p.trim_left for p in panel.paths], dtype=np.int64),
        tag_kind=kinds, path_inv_bnd=path_inv_bnd,
        path_cross_chrom=np.array(
            [len({nodes[n].chrom for n, _ in path.states}) > 1
             for path in panel.paths], dtype=bool),
    )


def count_support_flat(
    panel: Panel,
    winners: Winners,
    reads: ReadSet,
    d_over: int = 100,
    collect_audit: bool = True,
    min_density: float = 0.0,
    timings: Optional[Dict] = None,
) -> Tuple[Dict[str, List[int]], Dict[str, List[List[str]]]]:
    """``svjedi_tpu/align/pipeline.py:count_support`` over a flat winner ×
    owned-link table: the same counts and audit lines, in the same dict and
    list order.

    Entries are taken row by row, each row's path links in walk order, as
    ``count_support`` inserts them; its rules run per entry array:
    the density gate, the ``d_over`` overlap on both sides of the junction,
    allele exclusivity per (read, tag) (the allele of the first entry of the
    smallest row at the best score), then one count per (read, tag, link,
    allele). Each counted row's audit line is formatted once, from the
    panel's :class:`CountTable`, and serves all its crossings.

    ``timings`` (a dict, or None) gains ``count_entries`` (winner × owned
    entries tested), ``count_crossings`` (crossings counted: the sum of the
    counts), of those ``count_crossings_inv`` and ``count_crossings_bnd``
    (on links owned by INV or BND records), and ``audit_line_rows`` (audit
    lines formatted).
    """
    counts: Dict[str, List[int]] = {}
    audit: Dict[str, List[List[str]]] = {}
    if timings is not None:
        for key in ("count_entries", "count_crossings", "count_crossings_inv",
                    "count_crossings_bnd", "audit_line_rows"):
            timings.setdefault(key, 0)
    table = count_table(panel)
    rows = np.arange(len(winners.read))
    if min_density > 0 and len(rows):
        span_len = np.maximum(1, winners.te - winners.ts + 1)
        rows = np.flatnonzero(winners.score >= min_density * span_len)
    path = winners.path[rows].astype(np.int64)
    lo = table.offsets[path]
    n_own = table.offsets[path + 1] - lo
    row = np.repeat(rows, n_own)
    col = np.arange(len(row)) + np.repeat(lo - np.cumsum(n_own) + n_own, n_own)
    add(timings, "count_entries", len(row))
    j = table.junction[col]
    hit = ((j - winners.ts[row].astype(np.int64) >= d_over)
           & (winners.te[row].astype(np.int64) - j + 1 >= d_over))
    row, col = row[hit], col[hit]
    if not len(row):
        return counts, audit
    tag, allele, link = table.tag[col], table.allele[col], table.link[col]

    # (read, tag) segments, numbered in order of their first entry.
    n_tags = len(table.tag_names)
    _, first, inv = np.unique(winners.read[row].astype(np.int64) * n_tags + tag,
                              return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    seg = rank[inv]
    # Allele exclusivity: a segment holding both alleles keeps that of its
    # first entry at the best score (smallest row, then walk order).
    has = np.zeros((len(first), 2), dtype=bool)
    has[seg, allele] = True
    mixed = has.all(axis=1)
    if mixed.any():
        score = winners.score[row].astype(np.int64)
        order = np.lexsort((np.arange(len(row)), -score, seg))
        lead = order[np.r_[True, seg[order][1:] != seg[order][:-1]]]
        keep = ~mixed[seg] | (allele == allele[lead][seg])
        row, seg, tag, allele, link = (
            a[keep] for a in (row, seg, tag, allele, link))
    # One count per (segment, link, allele): its first entry.
    _, first = np.unique((seg * (int(link.max()) + 1) + link) * 2 + allele,
                         return_index=True)
    first.sort()
    # count_support's order: segment by segment, entries in order within.
    kept = first[np.argsort(seg[first], kind="stable")]
    row, tag, allele = row[kept], tag[kept], allele[kept]
    add(timings, "count_crossings", len(row))
    by_kind = np.bincount(table.tag_kind[tag], minlength=len(SV_KINDS) + 1)
    add(timings, "count_crossings_inv", by_kind[SV_KINDS.index("INV")])
    add(timings, "count_crossings_bnd", by_kind[SV_KINDS.index("BND")])

    tag_order = tag[np.sort(np.unique(tag, return_index=True)[1])].tolist()
    per_tag = np.bincount(tag * 2 + allele, minlength=2 * n_tags).reshape(-1, 2)
    names = table.tag_names
    for t, pair in zip(tag_order, per_tag[tag_order].tolist()):
        counts[names[t]] = pair
    if not collect_audit:
        return counts, audit

    uniq, inv = np.unique(row, return_inverse=True)
    lines = np.empty(len(uniq), dtype=object)
    lines[:] = _audit_lines(table, winners, reads, uniq)
    add(timings, "audit_line_rows", len(uniq))
    group = tag * 2 + allele
    order = np.argsort(group, kind="stable")
    group, ordered = group[order], lines[inv[order]].tolist()
    starts = np.flatnonzero(np.r_[True, group[1:] != group[:-1]])
    ends = np.r_[starts[1:], len(group)]
    by_group = {g: ordered[s:e] for g, s, e in
                zip(group[starts].tolist(), starts.tolist(), ends.tolist())}
    for t in tag_order:
        audit[names[t]] = [by_group.get(2 * t, []), by_group.get(2 * t + 1, [])]
    return counts, audit


def _audit_lines(table: CountTable, w: Winners, reads: ReadSet,
                 rows: np.ndarray) -> List[str]:
    """``svjedi_tpu/align/pipeline.py:_audit_line`` of each winner row in
    ``rows``, byte for byte."""
    read = w.read[rows].astype(np.int64)
    rlen = np.diff(reads.offsets)[read]
    strand = w.strand[rows].astype(np.int64)
    qs, qe = w.qs[rows].astype(np.int64), w.qe[rows].astype(np.int64)
    flip = strand != 0  # report on the forward read
    qs, qe = np.where(flip, rlen - 1 - qe, qs), np.where(flip, rlen - 1 - qs, qe)
    path = w.path[rows].astype(np.int64)
    ts_full = w.ts[rows].astype(np.int64) + table.trim_left[path]
    te_full = w.te[rows].astype(np.int64) + table.trim_left[path]
    if w.matches is not None:
        matches = w.matches[rows].astype(np.int64)
        blocklen = np.maximum(1, w.blocklen[rows].astype(np.int64))
    else:  # stats pass skipped: span-derived bounds
        q_len, t_len = qe - qs + 1, te_full - ts_full + 1
        matches, blocklen = np.minimum(q_len, t_len), np.maximum(q_len, t_len)
    mapq = (w.mapq[rows].astype(np.int64) if w.mapq is not None
            else np.full(len(rows), 60, dtype=np.int64))
    names = reads.names
    return [
        f"{names[r]}\t{n}\t{a}\t{b}\t{'+-'[s]}\t{h}\t{x}\t{y}\t{m}\t{k}\t{q}"
        f"\tid:f:{m / k:.6f}\t"
        for r, n, a, b, s, h, x, y, m, k, q in zip(
            read.tolist(), rlen.tolist(), qs.tolist(), (qe + 1).tolist(),
            strand.tolist(), table.head[path].tolist(), ts_full.tolist(),
            (te_full + 1).tolist(), matches.tolist(), blocklen.tolist(),
            mapq.tolist())
    ]


def _hbm_bytes(cfg: AlignConfig, device: torch.device) -> int:
    """Device memory size for budgeting.

    ``AlignConfig.hbm_bytes`` wins when set; otherwise a CUDA device reports
    its total memory (``torch.cuda.mem_get_info``) and any other device
    falls back to 16 GiB, as the JAX version does without device stats.
    """
    if cfg.hbm_bytes > 0:
        return cfg.hbm_bytes
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return 16 << 30


# Copied verbatim from svjedi_tpu/align/pipeline.py:_chunk_device_bytes.
def _chunk_device_bytes(n_bases: int) -> int:
    """Device bytes one chunk's input buffers pin until flushed.

    dev.upload rounds the chunk to a power-of-two buffer class (compile
    stability) and holds fwd+rc codes plus the 2-bit packed words —
    ~3 bytes per buffered base.
    """
    cap = 1 << max(12, (max(1, n_bases) - 1).bit_length())
    return 3 * cap


def use_device_scan(align_cfg: AlignConfig) -> bool:
    """Whether seeding scans minimizers on the device, by the JAX rule:
    ``device_seed`` is set, ``SVJT_DEVICE_SEED`` is not "0", and the native
    host library has ``svt_chain5`` (which chains from the scan's bitmask).
    """
    from ..utils.native import load_native

    native = load_native()
    return (
        align_cfg.device_seed
        and os.environ.get("SVJT_DEVICE_SEED", "1") != "0"
        and native is not None
        and hasattr(native._lib, "svt_chain5")
    )


#: ``align_and_count``'s ``timings``: host seconds of the calling thread's
#: steps (spans ``align.*`` in a profiler's trace), none inside another.
#: With the genotyping they cover a job.
LOOP_SPANS = (
    "merge_index_s", "pull_s", "upload_s", "scan_dispatch_s", "seed_s",
    "dp_s", "fwd_exec_s", "rev_disp_s", "rev_exec_s", "count_s", "trim_s",
    "merge_winners_s",
)
#: Seconds inside those: ``finalize_s`` in ``rev_disp_s``; ``prune_s``, the
#: audit's ``audit_table_s``, ``audit_assembly_s`` and ``audit_dp_s``, and
#: ``count_support_s`` in ``count_s``; and the seeder thread's
#: ``seed_cpu_s`` (its wall time per chunk) with ``scan_wait_s`` (the wait
#: for the device scan's bitmask), ``decoy_s`` (the decoy's
#: suppression of the chunk's candidates) and ``chain_s`` (lookup and
#: chaining, :func:`seed_candidates`) inside it.
NESTED_SPANS = (
    "finalize_s", "prune_s", "audit_table_s", "audit_assembly_s",
    "audit_dp_s", "count_support_s", "seed_cpu_s", "scan_wait_s",
    "decoy_s", "chain_s",
)
#: Work handed to each step: chunks pulled, candidates seeded, winners
#: counted; the forward DP's kept windows and Σ m, the reverse pass's
#: winners and Σ (qe + 1), the audit's pieces and Σ rows; the device
#: scan's positions (n_codes − k + 1), bases and read-offset entries; the
#: count's winner × owned entries, crossings counted and audit lines
#: formatted (:func:`count_support_flat`); and the all-types work: panel
#: candidates the decoy removed, crossings counted on INV and on BND links,
#: the forward and reverse DP rows on paths that own an INV or BND link,
#: and winners on paths whose walk spans two chromosomes; the rows entering
#: the three mask_level elections (:func:`elect`: ``finalize_chunk``'s
#: primary set and both prunes) and the rounds they took. The repeats'
#: work: the decoy-index rows competing in the decoy's suppression
#: (``decoy_chains``), Σ anchors over the seeded chains, each chain once
#: (``chain_anchors``), and the winners the score-density floor of
#: :func:`prune_secondaries` removes (``density_dropped``). The panel
#: chains :func:`suppress_merged` judged from the chain boundaries of the
#: merged scan's rows (``decoy_panel_chains``; 0 where it ran the
#: row-copying sequence).
WORK_COUNTERS = (
    "n_chunks", "n_candidates", "n_winners", "dp_problems", "dp_rows",
    "rev_problems", "rev_rows", "audit_pieces", "audit_rows",
    "scan_positions", "scan_codes", "scan_offsets", "count_entries",
    "count_crossings", "audit_line_rows", "decoy_suppressed",
    "count_crossings_inv", "count_crossings_bnd", "dp_rows_inv_bnd",
    "rev_rows_inv_bnd", "winners_cross_chrom", "elect_rows", "elect_rounds",
    "decoy_chains", "chain_anchors", "density_dropped", "decoy_panel_chains",
)


def align_and_count(
    reads: ReadSet,
    panel: Panel,
    index: PanelIndex,
    align_cfg: AlignConfig,
    genotype_cfg: GenotypeConfig,
    *,
    device: torch.device,
    collect_audit: bool = True,
    timings: Optional[Dict[str, float]] = None,
    chunk_reads: int = 16384,
    batch_size: int = 32768,
    decoy=None,
    devices: Optional[Sequence] = None,
    flush_every: Optional[int] = None,
    engine: Optional[str] = None,
):
    """Full aligner stage: reads + panel → (counts, audit, winners).

    Reads stream in fixed-size chunks. While chunk i's DP runs on
    ``device``, a seeder thread computes chunk i+1's candidates (host
    numpy/C++ only, from the device scan's bitmask where
    :func:`use_device_scan` holds); every device call, the scan included,
    stays on the calling thread.
    Results are fetched in flushes bounded by a device-memory budget.
    ``engine`` is the DP engine (:func:`resolve_engine`; None: ``gather``
    on the CPU, ``v3`` on a CUDA device).

    ``devices``: data-parallel mode (``--data-shards``). Chunk ``i`` is
    uploaded, scanned, DP-scored, reverse-passed and audited on
    ``devices[i % len(devices)]`` (the panel is uploaded once per device,
    one cache each); the per-(SV, allele) count merge, the pipeline's only
    cross-read reduction, is an associative sum over chunks on the host, so
    the devices' results combine exactly.

    ``timings`` (a dict, or None) gains the keys of :data:`LOOP_SPANS`,
    :data:`NESTED_SPANS` and :data:`WORK_COUNTERS`.
    """
    from . import dev_scan
    from . import device as dev

    engine = resolve_engine(engine, device)
    devices = list(devices) if devices else [device]
    use_dev_scan = use_device_scan(align_cfg)

    if timings is not None:
        for key in LOOP_SPANS + NESTED_SPANS:
            timings.setdefault(key, 0.0)
        for key in WORK_COUNTERS:
            timings.setdefault(key, 0)

    counts: Dict[str, List[int]] = {}
    audit: Dict[str, List[List[str]]] = {}
    winner_parts: List[Winners] = []
    panel_caches: List[Dict] = [{} for _ in devices]
    from ..config import resolve_min_count_density

    _min_density = resolve_min_count_density(genotype_cfg, align_cfg)

    # One minimizer scan serves panel AND decoy seeding: the merged index
    # carries decoy chromosome "paths" after the panel paths. A LIST of
    # DecoyShard objects selects the sharded competition instead
    # (dist/decoy_shard.py).
    n_panel_paths = len(index.path_len)
    seed_index = index
    sharded_decoy = isinstance(decoy, (list, tuple))
    if decoy is not None and not sharded_decoy:
        from .index import merge_indexes

        with span(timings, "merge_index_s", "align.merge_indexes"):
            seed_index = merge_indexes(index, decoy.index)

    # Phase 1 — dispatch: seed each chunk and enqueue its DP batches; all
    # results stay on device. Phase 2 — flush: one device→host copy for
    # every pending batch, the numpy winner reduction, one reverse-pass
    # round and counting. Pending chunks' input buffers are charged against
    # a fraction of device memory (AlignConfig.pending_input_frac).
    pending_budget = int(
        _hbm_bytes(align_cfg, device) * align_cfg.pending_input_frac
    )
    if flush_every is None:
        flush_every = 32  # count backstop; the byte budget is the bound
    pending: List[Tuple[int, ReadSet, ChunkDispatch]] = []
    pending_bytes = [0]  # list: mutated by the nested chunk loop

    def count_work(disp, *keys):
        for key in keys:
            add(timings, key, getattr(disp, key))

    def accumulate(start, chunk, disp, winners):
        with span(timings, "prune_s", "align.prune"):
            winners = prune_secondaries(winners, chunk, align_cfg,
                                        timings=timings)
            winners = cross_cluster_prune(winners, chunk, timings=timings)
        if collect_audit:
            with span(None, None, "align.audit"):
                compute_winner_stats(chunk, panel, winners, align_cfg,
                                     disp.device_data, timings=timings)
        with span(timings, "count_support_s", "align.count_support"):
            chunk_counts, chunk_audit = count_support_flat(
                panel, winners, chunk, genotype_cfg.d_over, collect_audit,
                min_density=_min_density, timings=timings,
            )
        for tag, pair in chunk_counts.items():
            entry = counts.setdefault(tag, [0, 0])
            entry[0] += pair[0]
            entry[1] += pair[1]
        for tag, pair in chunk_audit.items():
            entry = audit.setdefault(tag, [[], []])
            entry[0].extend(pair[0])
            entry[1].extend(pair[1])
        winners.read = winners.read + start  # rebase to global read ids
        winner_parts.append(winners)
        if timings is not None:
            timings["n_winners"] += int(len(winners.read))
            add(timings, "winners_cross_chrom", count_table(
                panel).path_cross_chrom[winners.path].sum())

    def finish(items, fetched):
        """The flush's tail for ``items`` ((start, chunk, disp) each) and
        their fetched forward rows: the winners, the reverse pass (one
        dispatch round and one bulk fetch for all; nothing for one-pass
        rows), the prunes, the audit and the count."""
        finalized = []
        with span(timings, "rev_disp_s", "align.rev"):
            for (start, chunk, disp), host_rows in zip(items, fetched):
                with span(timings, "finalize_s", "align.finalize"):
                    winners, win = finalize_chunk(
                        chunk, index, align_cfg, disp, host_rows
                    )
                count_work(disp, "elect_rows", "elect_rounds")
                dispatch_rev(align_cfg, disp, winners, win)
                count_work(disp, "rev_problems", "rev_rows",
                           "rev_rows_inv_bnd")
                finalized.append(winners)
        with span(timings, "rev_exec_s", "align.fetch_rev"):
            rev_rows_all = collect_rev([d for (_, _, d) in items])
        with span(timings, "count_s", "align.count"):
            for (start, chunk, disp), winners, rev_rows in zip(
                items, finalized, rev_rows_all
            ):
                patch_rev(align_cfg, disp, winners, rev_rows)
                accumulate(start, chunk, disp, winners)

    def flush_retry():
        """Per-chunk recovery: the batched fetch failed, so each pending
        chunk is re-dispatched from its kept candidates on the same device
        and processed alone, with one retry from a fresh upload."""
        for start, chunk, disp in pending:
            for attempt in (0, 1):
                try:
                    if attempt == 0:
                        device_data = disp.device_data
                    else:
                        device_data = dev.upload(
                            chunk.codes, panel,
                            dev.device_of(disp.device_data), {},
                        )
                    d2 = dispatch_chunk(
                        chunk, panel, index, disp.cands, align_cfg,
                        device_data, batch_size=batch_size, engine=engine,
                    )
                    count_work(d2, "dp_problems", "dp_rows",
                               "dp_rows_inv_bnd")
                    with span(timings, "fwd_exec_s", "align.fetch"):
                        fetched = collect_outs([d2])
                    finish([(start, chunk, d2)], fetched)
                    break
                except Exception:
                    if attempt:
                        raise
                    print(
                        f"[align] WARNING: chunk@{start} failed; retrying",
                        file=sys.stderr,
                    )
                    if timings is not None:
                        timings["n_retries"] = timings.get("n_retries", 0) + 1
        pending.clear()

    def flush():
        try:
            with span(timings, "fwd_exec_s", "align.fetch"):
                per_chunk = collect_outs([d for (_, _, d) in pending])
        except Exception as exc:
            print(
                f"[align] WARNING: bulk fetch failed ({exc!r}); "
                "falling back to per-chunk recovery",
                file=sys.stderr,
            )
            if timings is not None:
                timings["n_retries"] = timings.get("n_retries", 0) + 1
            flush_retry()
            return
        finish(pending, per_chunk)
        pending.clear()
        with span(timings, "trim_s", "align.trim"):
            _malloc_trim()

    chain_params = ChainParams(
        min_anchors=align_cfg.min_anchors,
        max_chains=align_cfg.max_chains,
        max_gap=align_cfg.chain_max_gap,
        drift_abs=align_cfg.chain_drift_abs,
        drift_permille=align_cfg.chain_drift_permille,
        block_rows=align_cfg.block_rows,
        ext_min_anchors=align_cfg.chain_ext_min_anchors,
    )
    device_datas: Dict[int, object] = {}

    def suppress_sharded(chunk: ReadSet, cands: Candidates, spent):
        """dist/decoy_shard.py:suppress_candidates_sharded, with the decoy
        rows it hands in counted into ``spent``."""
        from ..dist.decoy_shard import (
            apply_global_chain_cap, union_decoy_chains,
        )
        from .decoy import suppress_candidates

        shards = list(decoy)
        dec = apply_global_chain_cap(
            union_decoy_chains(chunk, shards, chain_params,
                               threads=align_cfg.threads),
            len(shards[0].decoy.index.path_len),
            chain_params.max_chains)
        spent["decoy_chains"] = len(dec)
        keep, dec_other, dec_same = suppress_candidates(
            chunk, cands, index, shards[0].decoy, chain_params,
            threads=align_cfg.threads, dec=dec, return_margins=True,
        )
        cands.dec_other = dec_other
        cands.dec_same = dec_same
        spent["decoy_suppressed"] = int((~keep).sum())
        return cands if keep.all() else cands.take(keep)

    def seed_chunk(chunk: ReadSet, scan_out=None):
        """Seed + decoy-suppress one chunk (runs on the seeder thread).

        Host lookup and chaining, after the host scan or (``scan_out``, the
        device scan's pending bitmask) one wait for the bitmask's copy; no
        device call. Returns (candidates, {"seed_cpu_s": the call's seconds,
        "scan_wait_s": the wait's, "chain_s": the lookup and chaining's,
        "decoy_s": the decoy's, and the counts "chain_anchors" (Σ anchors
        of the seeded chains), "decoy_chains" (the decoy rows competing),
        "decoy_suppressed" (the panel candidates removed) and
        "decoy_panel_chains" (the panel chains :func:`suppress_merged`
        judged from chain boundaries)}).
        """
        spent: Dict[str, float] = {}  # and the counts
        with span(spent, "seed_cpu_s", "align.seed"):
            bits = None
            if scan_out is not None:
                with span(spent, "scan_wait_s", "align.seed.scan_wait"):
                    bits = dev_scan.fetch_bitmask(scan_out)
            with span(spent, "chain_s", "align.seed.chain"):
                cands = seed_candidates(
                    chunk, seed_index, chain_params=chain_params,
                    threads=align_cfg.threads,
                    panel_path_limit=(
                        n_panel_paths
                        if decoy is not None and not sharded_decoy
                        else 0
                    ),
                    bits=bits,
                )
            # A chain's blocks are contiguous rows sharing its id.
            head = np.ones(len(cands), dtype=bool)
            head[1:] = cands.chain[1:] != cands.chain[:-1]
            spent["chain_anchors"] = int(cands.n_anchors[head].sum())
            if decoy is not None and len(cands):
                with span(spent, "decoy_s", "align.seed.decoy"):
                    if not sharded_decoy:
                        cands, counts = suppress_merged(
                            chunk, cands, n_panel_paths, index, decoy,
                            threads=align_cfg.threads, head=head)
                        spent.update(counts)
                    else:
                        cands = suppress_sharded(chunk, cands, spent)
        return cands, spent

    # Chunk pipeline: while chunk i's DP batches execute on the device, the
    # seeder thread computes chunk i+1's candidates. The first chunk's seed
    # overlaps nothing, so it is a quarter chunk. ``reads`` may be an eager
    # ReadSet (chunks are zero-copy slices) or a lazy io.fastq.ReadStream
    # (identical chunk boundaries, byte-identical results).
    from concurrent.futures import ThreadPoolExecutor

    first = max(256, chunk_reads // 4)
    if isinstance(reads, ReadSet):

        def _chunk_iter():
            starts = [0]
            nxt = first if reads.n_reads > chunk_reads else chunk_reads
            while nxt < reads.n_reads:
                starts.append(nxt)
                nxt += chunk_reads
            bounds = starts + [reads.n_reads]
            for a, b in zip(bounds[:-1], bounds[1:]):
                yield a, reads.slice(a, b)

        chunk_iter = _chunk_iter()
    else:

        def _stream_iter():
            start = 0
            for chunk in reads.chunks(chunk_reads, first=first):
                yield start, chunk
                start += chunk.n_reads

        chunk_iter = _stream_iter()

    with ThreadPoolExecutor(max_workers=1) as seeder:
        seed_futures: Dict[int, object] = {}
        chunk_map: Dict[int, Tuple[int, ReadSet]] = {}

        def pull(ci: int) -> bool:
            """Pull chunk ci, upload it, enqueue its device scan and submit
            its seed. Runs on this thread, as every device call does."""
            with span(timings, "pull_s", "align.pull"):
                item = next(chunk_iter, None)
            if item is None:
                return False
            add(timings, "n_chunks", 1)
            chunk_map[ci] = item
            di = ci % len(devices)
            with span(timings, "upload_s", "align.upload"):
                dd = dev.upload(item[1].codes, panel, devices[di],
                                panel_caches[di], offsets=item[1].offsets)
            device_datas[ci] = dd
            scan_out = None
            if use_dev_scan:
                with span(timings, "scan_dispatch_s", "align.scan"):
                    scan_out = dev_scan.dispatch_scan(
                        dd, seed_index.k, seed_index.w)
                add(timings, "scan_positions",
                    max(0, dd.n_codes - seed_index.k + 1))
                add(timings, "scan_codes", dd.n_codes)
                add(timings, "scan_offsets", dd.offsets32.numel())
            seed_futures[ci] = seeder.submit(seed_chunk, item[1], scan_out)
            return True

        pull(0)
        ci = 0
        while ci in chunk_map:
            pull(ci + 1)
            start, chunk = chunk_map.pop(ci)
            with span(timings, "seed_s", "align.seed_wait"):
                cands, spent = seed_futures.pop(ci).result()
            with span(timings, "dp_s", "align.dispatch"):
                device_data = device_datas.pop(ci)
                disp = dispatch_chunk(
                    chunk, panel, index, cands, align_cfg, device_data,
                    batch_size=batch_size, engine=engine,
                )
            count_work(disp, "dp_problems", "dp_rows", "dp_rows_inv_bnd")
            if timings is not None:
                for key, amount in spent.items():
                    timings[key] += amount
                timings["n_candidates"] += len(cands)
            pending.append((start, chunk, disp))
            pending_bytes[0] += _chunk_device_bytes(chunk.codes.size)
            if len(pending) >= flush_every or pending_bytes[0] > pending_budget:
                flush()
                pending_bytes[0] = 0
            ci += 1
        flush()

    with span(timings, "merge_winners_s", "align.merge_winners"):
        if winner_parts:
            merged = Winners(
                *[
                    np.concatenate([getattr(w, f) for w in winner_parts])
                    for f in (
                        "read", "cluster", "path", "strand", "score",
                        "qs", "qe", "ts", "te",
                    )
                ]
            )
            for f in ("matches", "blocklen", "mapq", "anchor_ts", "anchor_te",
                      "rescore_deficit", "rescore_flag"):
                if all(getattr(w, f) is not None for w in winner_parts):
                    setattr(
                        merged, f,
                        np.concatenate([getattr(w, f) for w in winner_parts]),
                    )
        else:
            empty = np.zeros(0, np.int64)
            merged = Winners(*([empty] * 9))
    return counts, audit, merged
