"""Alignment pipeline: seeds → bucketed DP batches → winners → allele counts.

PyTorch counterpart of ``svjedi_tpu/align/pipeline.py`` on one
``torch.device``. Candidates are scored by one of three engines
(``align/device.py``), chosen as the JAX package chooses (:func:`resolve_engine`):
``gather`` on the CPU (the one-pass ``band_dp_batch``), ``v3`` on a CUDA
device (the two-pass v3 kernel: forward pass on every candidate, reverse pass
on the winners), or ``dma`` when named (the one-pass fused-fetch kernel).
Seeding, chaining and the decoy competition run on the host, in this
package's copies of the JAX package's host modules; the minimizer scan runs
on the host.

The numpy-only helpers are verbatim copies of the JAX module's (that module
imports JAX, so they cannot be imported from it); each names its source and
``tests/test_torch_align.py`` holds each copy to the original.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig, GenotypeConfig
from ..graph.cluster import Panel
from ..io.fastq import ReadSet
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
        cands=cands, rw_start=np.zeros(len(cands), dtype=np.int64)
    )
    if len(cands) == 0:
        return disp

    rw_start, m32, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
        reads, index, cands, cfg, device_data
    )
    disp.rw_start = rw_start
    order = np.flatnonzero(keep)
    bucket_of = np.array(
        [_pick_bucket(int(v), cfg.buckets) for v in m32[order]],
        dtype=np.int64,
    )

    disp.q_start = q_start
    disp.t_start = t_start
    disp.t_lo = t_lo
    disp.t_hi = t_hi
    disp.device_data = device_data
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

# Copied verbatim from svjedi_tpu/align/pipeline.py:finalize_chunk.
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
    key_s = key[order2]
    grp_start = np.ones(len(order2), dtype=bool)
    grp_start[1:] = key_s[1:] != key_s[:-1]
    kept_rows: List[int] = []
    #: per kept row: best SAME-PATH challenger chain score rejected for
    #: >=50% read-interval overlap with it (repeat-shifted placement on the
    #: same haplotype sequence). Cross-path overlap rejections are allele
    #: competition — the graph aligner resolves those at full confidence
    #: (minigraph maps against the whole graph and reports one path), so
    #: they must NOT depress mapq.
    kept_s2: List[int] = []
    MAX_PRIMARY = 8
    starts = np.flatnonzero(grp_start)
    bounds = np.append(starts, len(order2))
    for gi in range(len(starts)):
        kept_lo: List[int] = []
        kept_hi: List[int] = []
        kept_base = len(kept_rows)
        for row in order2[bounds[gi] : bounds[gi + 1]]:
            if len(kept_lo) >= MAX_PRIMARY:
                break
            lo, hi = int(a_qlo[row]), int(a_qhi[row])
            span = max(1, hi - lo)
            ok = True
            for ki, (klo, khi) in enumerate(zip(kept_lo, kept_hi)):
                ov = min(hi, khi) - max(lo, klo)
                if ov >= 0.5 * span:
                    ok = False
                    kept_idx = kept_base + ki
                    if a_path[row] == a_path[kept_rows[kept_idx]]:
                        kept_s2[kept_idx] = max(
                            kept_s2[kept_idx],
                            int(chain_score[alive[row]]),
                        )
                    break
            if ok:
                kept_lo.append(lo)
                kept_hi.append(hi)
                kept_rows.append(row)
                kept_s2.append(0)
    win_chain = alive[np.asarray(kept_rows, dtype=np.int64)]

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
        s2=np.asarray(kept_s2, dtype=np.int64),
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
        # Reverse windows are flipped before the kernel (valid rows at the
        # end), so row bounds cannot skip their sentinel prefix: run all
        # rows (rebucketing above already shrank the window).
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


# Copied verbatim from svjedi_tpu/align/pipeline.py:prune_secondaries.
def prune_secondaries(
    winners: Winners, reads: ReadSet, cfg: AlignConfig = None
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
    (read, cluster) on them before counting.
    """
    n = len(winners.read)
    if n == 0:
        return winners
    rlen = reads.lengths[winners.read]
    q_lo = np.where(winners.strand == 0, winners.qs, rlen - 1 - winners.qe)
    q_hi = np.where(winners.strand == 0, winners.qe, rlen - 1 - winners.qs)
    key = winners.read * (winners.cluster.max() + 1) + winners.cluster
    order = np.lexsort((np.arange(n), -winners.score, key))
    keep = np.zeros(n, dtype=bool)
    dense = np.ones(n, dtype=bool)
    if cfg is not None:
        span = np.maximum(
            winners.qe - winners.qs + 1, winners.te - winners.ts + 1
        )
        dense = winners.score * 1000 >= cfg.min_density_millis * span
    key_s = key[order]
    starts = np.flatnonzero(
        np.concatenate([[True], key_s[1:] != key_s[:-1]])
    )
    bounds = np.append(starts, n)
    for gi in range(len(starts)):
        kept: List[Tuple[int, int]] = []
        for row in order[bounds[gi] : bounds[gi + 1]]:
            if not dense[row]:
                continue
            lo, hi = int(q_lo[row]), int(q_hi[row])
            span = max(1, hi - lo + 1)
            ok = True
            for klo, khi in kept:
                ov = min(hi, khi) - max(lo, klo) + 1
                if ov >= 0.5 * span:
                    ok = False
                    break
            if ok:
                kept.append((lo, hi))
                keep[row] = True
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

# Copied verbatim from svjedi_tpu/align/pipeline.py:cross_cluster_prune.
def cross_cluster_prune(winners: Winners, reads: ReadSet) -> Winners:
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
    keep = np.zeros(n, dtype=bool)
    order = np.lexsort((np.arange(n), -dens, winners.read))
    read_s = winners.read[order]
    starts = np.flatnonzero(
        np.concatenate([[True], read_s[1:] != read_s[:-1]])
    )
    bounds = np.append(starts, n)
    for gi in range(len(starts)):
        kept: List[Tuple[int, int]] = []
        for row in order[bounds[gi] : bounds[gi + 1]]:
            lo, hi = int(q_lo[row]), int(q_hi[row])
            sp = max(1, hi - lo + 1)
            if all(
                min(hi, kh) - max(lo, kl) + 1 < 0.5 * sp for kl, kh in kept
            ):
                kept.append((lo, hi))
                keep[row] = True
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

# Copied verbatim from svjedi_tpu/align/pipeline.py:count_support.
def count_support(
    panel: Panel,
    winners: Winners,
    reads: ReadSet,
    d_over: int = 100,
    collect_audit: bool = True,
    min_density: float = 0.0,
) -> Tuple[Dict[str, List[int]], Dict[str, List[List[str]]]]:
    """Per-(SV, allele) support counts from winning alignments.

    Returns (counts, audit) where counts maps lookup tags to [ref, alt] and
    audit mirrors the reference's informative_aln.json schema (GAF-like
    lines per counted alignment, filter-alignments.py:163-166).

    Two single-alignment-per-read invariants of the reference are imposed
    on the primary set (minigraph emits ONE whole-graph alignment per read
    locus, which cannot do either):

    - dedup per (read, link, tag, allele): two kept fragments crossing the
      SAME link count once (one link can carry several tags — co-located
      SVs share breakpoint links — each of which counts);
    - allele exclusivity per (read, SV): a read whose kept fragments cross
      links of BOTH alleles of one SV (e.g. a ref fragment at one junction
      of a long INV plus an alt fragment at the other) supports only the
      allele of its best-scoring fragment.
    """
    counts: Dict[str, List[int]] = {}
    audit: Dict[str, List[List[str]]] = {}
    # Density gate (GenotypeConfig.min_count_density): winners whose score
    # per target base falls below the threshold are discontinuity bridges
    # and contribute no crossings (mirrored on-mesh in
    # dist/count_merge.build_entry_table).
    dense_ok = None
    if min_density > 0 and len(winners.read):
        span = np.maximum(1, winners.te - winners.ts + 1)
        dense_ok = winners.score >= min_density * span
    # (read, tag) -> list of qualifying (score, row, link, allele)
    contrib: Dict[Tuple[int, str], List[Tuple[int, int, int, int]]] = {}
    for i in range(len(winners.read)):
        if dense_ok is not None and not dense_ok[i]:
            continue
        path = panel.paths[int(winners.path[i])]
        ts, te = int(winners.ts[i]), int(winners.te[i])
        for tag, allele, j, li in path.owned:
            if (j - ts) >= d_over and (te - j + 1) >= d_over:
                contrib.setdefault((int(winners.read[i]), tag), []).append(
                    (int(winners.score[i]), i, li, allele)
                )
    for (read_id, tag), rows in contrib.items():
        if len({a for (_, _, _, a) in rows}) > 1:
            best = max(s for (s, _, _, _) in rows)
            best_i = min(i for (s, i, _, _) in rows if s == best)
            keep = next(a for (s, i, _, a) in rows if i == best_i)
            rows = [r for r in rows if r[3] == keep]
        seen: set = set()
        for _score, i, li, allele in rows:
            if (li, allele) in seen:
                continue
            seen.add((li, allele))
            entry = counts.setdefault(tag, [0, 0])
            entry[allele] += 1
            if collect_audit:
                line = _audit_line(panel, winners, reads, i)
                audit.setdefault(tag, [[], []])[allele].append(line)
    return counts, audit


def compute_winner_stats(
    reads: ReadSet,
    panel: Panel,
    winners: Winners,
    cfg: AlignConfig,
    device: torch.device,
) -> None:
    """Fill ``winners.matches``/``blocklen`` by re-scoring winning spans.

    The audit pass: each winner's alignment rectangle [qs..qe] x [ts..te]
    is split into <= ``block_rows``-row pieces whose target windows follow
    the linearly-interpolated span diagonal, and each piece is re-run
    through the stats-tracking banded DP on ``device`` (band doubled to
    absorb residual drift). Summed piece stats give the exact-match count
    and block length the reference's GAF consumers expect
    (filter-alignments.py:193-196).
    """
    from .extend import band_dp_stats_batch

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

    # Piece table: (winner, piece q window [a, b), t window start).
    p_win, p_a, p_b, p_t0 = [], [], [], []
    for wi in range(n):
        qs, qe = int(winners.qs[wi]), int(winners.qe[wi])
        ts = int(winners.ts[wi])
        span = qe - qs + 1
        if span <= 0:
            continue
        for a in range(qs, qe + 1, PIECE):
            b = min(a + PIECE, qe + 1)
            t_a = ts + round((a - qs) * int(tspan[wi]) / span)
            p_win.append(wi)
            p_a.append(a)
            p_b.append(b)
            p_t0.append(t_a - B2 // 2)
    p_win = np.asarray(p_win, np.int64)
    p_a = np.asarray(p_a, np.int64)
    p_b = np.asarray(p_b, np.int64)
    p_t0 = np.asarray(p_t0, np.int64)
    p_m = p_b - p_a

    order = np.argsort(p_m, kind="stable")
    bucket_of = np.array(
        [_pick_bucket(int(v), cfg.buckets) for v in p_m[order]],
        dtype=np.int64,
    )
    rc_cache: Dict[int, np.ndarray] = {}

    def oriented_read(read_id: int, strand: int) -> np.ndarray:
        if strand == 0:
            return reads.seq(read_id)
        if read_id not in rc_cache:
            rc_cache[read_id] = revcomp_codes(reads.seq(read_id))
        return rc_cache[read_id]

    score_sum = np.zeros(n, dtype=np.int64)
    n_diag_sum = np.zeros(n, dtype=np.int64)
    for bucket in sorted(set(bucket_of.tolist())):
        sel = order[bucket_of == bucket]
        for lo in range(0, len(sel), 4096):
            chunk = sel[lo : lo + 4096]
            P = len(chunk)
            q = np.full((P, bucket), 4, dtype=np.int8)
            t = np.full((P, bucket + B2), 4, dtype=np.int8)
            for row, pi in enumerate(chunk):
                wi = int(p_win[pi])
                a, b = int(p_a[pi]), int(p_b[pi])
                window = oriented_read(
                    int(winners.read[wi]), int(winners.strand[wi])
                )[a:b]
                q[row, : len(window)] = window
                # Target clamped to the winning span so the rectangle
                # union stays exact.
                seq = panel.paths[int(winners.path[wi])].seq
                t_start = int(p_t0[pi])
                src_lo = max(int(winners.ts[wi]), t_start, 0)
                src_hi = min(
                    int(winners.te[wi]) + 1,
                    t_start + bucket + B2,
                    len(seq),
                )
                if src_hi > src_lo:
                    t[row, src_lo - t_start : src_hi - t_start] = seq[
                        src_lo:src_hi
                    ]
            out = band_dp_stats_batch(
                torch.from_numpy(q).to(device), torch.from_numpy(t).to(device),
                B2, params,
            )
            host = torch.stack(
                [out["matches"], out["n_diag"], out["score"]]
            ).cpu().numpy().astype(np.int64)
            np.add.at(winners.matches, p_win[chunk], host[0])
            np.add.at(n_diag_sum, p_win[chunk], host[1])
            np.add.at(score_sum, p_win[chunk], host[2])
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


# Copied verbatim from svjedi_tpu/align/pipeline.py:_audit_line.
def _audit_line(panel: Panel, w: Winners, reads: ReadSet, i: int) -> str:
    from ..graph.build import REV

    path = panel.paths[int(w.path[i])]
    graph = panel.graph
    read_id = int(w.read[i])
    rlen = int(reads.lengths[read_id])
    strand = int(w.strand[i])
    qs, qe = int(w.qs[i]), int(w.qe[i])
    if strand:  # report on the forward read
        qs, qe = rlen - 1 - qe, rlen - 1 - qs
    path_str = "".join(
        ("<" if s == REV else ">") + graph.nodes[n].name for (n, s) in path.states
    )
    ts_full = int(w.ts[i]) + path.trim_left
    te_full = int(w.te[i]) + path.trim_left
    if w.matches is not None:
        matches = int(w.matches[i])
        blocklen = max(1, int(w.blocklen[i]))
    else:  # stats pass skipped: degrade to span-derived bounds
        matches = min(qe - qs + 1, te_full - ts_full + 1)
        blocklen = max(qe - qs + 1, te_full - ts_full + 1)
    mapq = int(w.mapq[i]) if w.mapq is not None else 60
    return "\t".join(
        [
            reads.names[read_id],
            str(rlen),
            str(qs),
            str(qe + 1),
            "+-"[strand],
            path_str,
            str(path.full_len),
            str(ts_full),
            str(te_full + 1),
            str(matches),
            str(blocklen),
            str(mapq),
            f"id:f:{matches / blocklen:.6f}",
        ]
    ) + "\t"


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

#: Whether the note that the device minimizer scan is not ported was shown.
_seed_note_shown = False


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
    numpy/C++ only); every device call stays on the calling thread.
    Results are fetched in flushes bounded by a device-memory budget.
    ``engine`` is the DP engine (:func:`resolve_engine`; None: ``gather``
    on the CPU, ``v3`` on a CUDA device).
    """
    import time

    from . import device as dev

    global _seed_note_shown
    engine = resolve_engine(engine, device)
    if devices is not None:
        raise NotImplementedError(
            "devices= (the --data-shards chunk round-robin) is not ported "
            "yet: ROADMAP.md queue A, M9"
        )
    if (
        align_cfg.device_seed
        and os.environ.get("SVJT_DEVICE_SEED", "1") != "0"
        and not _seed_note_shown
    ):
        print(
            "[align] note: the device minimizer scan is not ported yet; "
            "seeding runs the host scan (same candidates)",
            file=sys.stderr,
        )
        _seed_note_shown = True

    if timings is not None:
        timings.setdefault("seed_s", 0.0)
        timings.setdefault("dp_s", 0.0)
        timings.setdefault("count_s", 0.0)
        timings.setdefault("n_candidates", 0)
        timings.setdefault("n_winners", 0)

    counts: Dict[str, List[int]] = {}
    audit: Dict[str, List[List[str]]] = {}
    winner_parts: List[Winners] = []
    panel_cache: Dict = {}
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

    def accumulate(start, chunk, disp, winners):
        winners = prune_secondaries(winners, chunk, align_cfg)
        winners = cross_cluster_prune(winners, chunk)
        if collect_audit:
            compute_winner_stats(chunk, panel, winners, align_cfg, device)
        chunk_counts, chunk_audit = count_support(
            panel, winners, chunk, genotype_cfg.d_over, collect_audit,
            min_density=_min_density,
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

    def process_one(start, chunk, disp):
        """Full single-chunk path (the per-chunk retry unit)."""
        (host_rows,) = collect_outs([disp])
        winners, win = finalize_chunk(chunk, index, align_cfg, disp, host_rows)
        dispatch_rev(align_cfg, disp, winners, win)
        (rev_rows,) = collect_rev([disp])
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
                        device_data = dev.upload(chunk.codes, panel, device, {})
                    d2 = dispatch_chunk(
                        chunk, panel, index, disp.cands, align_cfg,
                        device_data, batch_size=batch_size, engine=engine,
                    )
                    process_one(start, chunk, d2)
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
        tf0 = time.perf_counter()
        try:
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
        tf1 = time.perf_counter()
        # Pass 2: winner starts via the v3 reverse pass (one more dispatch
        # round + one bulk fetch for all chunks; nothing for one-pass rows).
        finalized = []
        for (start, chunk, disp), host_rows in zip(pending, per_chunk):
            winners, win = finalize_chunk(
                chunk, index, align_cfg, disp, host_rows
            )
            dispatch_rev(align_cfg, disp, winners, win)
            finalized.append(winners)
        tf2 = time.perf_counter()
        rev_rows_all = collect_rev([d for (_, _, d) in pending])
        t2 = time.perf_counter()
        if timings is not None:
            timings["fwd_exec_s"] = timings.get("fwd_exec_s", 0.0) + (tf1 - tf0)
            timings["rev_disp_s"] = timings.get("rev_disp_s", 0.0) + (tf2 - tf1)
            timings["rev_exec_s"] = timings.get("rev_exec_s", 0.0) + (t2 - tf2)
        for (start, chunk, disp), winners, rev_rows in zip(
            pending, finalized, rev_rows_all
        ):
            patch_rev(align_cfg, disp, winners, rev_rows)
            accumulate(start, chunk, disp, winners)
        pending.clear()
        if timings is not None:
            timings["count_s"] += time.perf_counter() - t2
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

    def seed_chunk(chunk: ReadSet):
        """Seed + decoy-suppress one chunk (runs on the seeder thread).

        Host scan, lookup and chaining only. Returns (candidates,
        cpu_seconds).
        """
        ts0 = time.perf_counter()
        cands = seed_candidates(
            chunk, seed_index, chain_params=chain_params,
            threads=align_cfg.threads,
            panel_path_limit=(
                n_panel_paths
                if decoy is not None and not sharded_decoy
                else 0
            ),
        )
        if decoy is not None and len(cands):
            if sharded_decoy:
                from ..dist.decoy_shard import (
                    suppress_candidates_sharded,
                )

                keep, dec_other, dec_same = suppress_candidates_sharded(
                    chunk, cands, index, list(decoy), chain_params,
                    threads=align_cfg.threads,
                )
            else:
                from .decoy import suppress_candidates

                is_panel = cands.path < n_panel_paths
                dec = cands.take(~is_panel, path_offset=-n_panel_paths)
                cands = cands.take(is_panel)
                keep, dec_other, dec_same = suppress_candidates(
                    chunk, cands, index, decoy, chain_params,
                    threads=align_cfg.threads, dec=dec, return_margins=True,
                )
            cands.dec_other = dec_other
            cands.dec_same = dec_same
            if not keep.all():
                cands = cands.take(keep)
        return cands, time.perf_counter() - ts0

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
            """Pull chunk ci, upload it and submit its seed."""
            item = next(chunk_iter, None)
            if item is None:
                return False
            chunk_map[ci] = item
            device_datas[ci] = dev.upload(
                item[1].codes, panel, device, panel_cache
            )
            seed_futures[ci] = seeder.submit(seed_chunk, item[1])
            return True

        pull(0)
        ci = 0
        while ci in chunk_map:
            pull(ci + 1)
            start, chunk = chunk_map.pop(ci)
            t0 = time.perf_counter()
            cands, seed_cpu = seed_futures.pop(ci).result()
            t1 = time.perf_counter()
            device_data = device_datas.pop(ci)
            disp = dispatch_chunk(
                chunk, panel, index, cands, align_cfg, device_data,
                batch_size=batch_size, engine=engine,
            )
            t2 = time.perf_counter()
            pending.append((start, chunk, disp))
            pending_bytes[0] += _chunk_device_bytes(chunk.codes.size)
            if len(pending) >= flush_every or pending_bytes[0] > pending_budget:
                flush()
                pending_bytes[0] = 0

            if timings is not None:
                timings["seed_s"] += t1 - t0
                timings["seed_cpu_s"] = (
                    timings.get("seed_cpu_s", 0.0) + seed_cpu
                )
                timings["dp_s"] += t2 - t1
                timings["n_candidates"] += len(cands)
            ci += 1
        flush()

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
