"""The audit re-score's stats DP (A1): score, matches, n_diag and the end.

PyTorch counterpart of ``svjedi_tpu/align/extend.py:band_dp_stats_batch``
(a jitted ``lax.scan`` in the JAX package, not a Pallas kernel). Inputs
keep the JAX layout: read windows ``q (P, M)`` and target windows
``t (P, M + band)``, int8 with sentinel 4. Per problem it returns the best
score, its end ``(qe, te)`` (the first row whose maximum beats the best,
then the lowest band offset in that row) and, along the optimal path
ending there, the exact matches and the diagonal steps.

:func:`band_dp_stats` launches the hand-written CUDA kernel
(``csrc/band_dp_stats.cu``, entry ``band_dp_stats_launch``, on the one-pass
body of ``csrc/band_dp_body.cuh``) on CUDA tensors and takes
:func:`band_dp_stats_ref`, its plain PyTorch version (the row loop of
``align/extend.py``), on CPU tensors; any other device raises. The kernel
carries ``n_diag << 16 | matches`` per cell, so ``M < 65536``.

:func:`band_dp_stats_flat` is the same DP on windows it fetches itself, the
contract of ``kernels/band_dp_dma.py`` (K3): the chunk's resident buffers
``reads2`` and ``panel_padded`` (``align/device.py``) and per piece the
int32 offsets of :data:`PIECE_ROWS`. On CUDA tensors it launches the
kernel's fused-fetch entry (``band_dp_stats_flat_launch``); on CPU tensors
it gathers the windows (``align/device.py:gather_windows``) and takes
:func:`band_dp_stats_ref`. :func:`pack_pieces` builds the offsets and
refuses any that leaves int32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..align.device import gather_windows
from ..align.extend import DPParams, _band_dp_rows
from .band_dp import check_windows
from .band_dp_dma import check_flat_inputs

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0

#: Per-problem outputs, in the kernel's column order.
STATS_COLS = ("score", "matches", "n_diag", "qe", "te")
#: Bands the kernel builds: K4's two layouts and 32 lanes x 16 cells.
KERNEL_BANDS = (128, 256, 512)
#: Rows of :func:`band_dp_stats_flat`'s (5, P) int32 piece table: the read
#: window's start in ``reads2``, the target window's lane 0 in
#: ``panel_padded``, the read rows, and the target's valid [t_lo, t_hi).
PIECE_ROWS = ("q_start", "t_start", "m", "t_lo", "t_hi")


def _check(q: torch.Tensor, t: torch.Tensor, band: int) -> None:
    check_windows(q, t, band)
    check_rider(q.shape[1])


def check_rider(rows: int) -> None:
    """Raise where the packed rider ``n_diag << 16 | matches`` cannot hold
    a path over ``rows`` rows (each diagonal step takes one row)."""
    if not 0 <= rows < (1 << 16):
        raise ValueError(
            f"the packed rider n_diag << 16 | matches needs M < 65536 "
            f"(got M={rows})"
        )


def check_kernel_shape(band: int, rows: int) -> None:
    """The kernel's builds: band 128, 256 or 512, rows in blocks of its
    cells per lane (8; 16 at band 512)."""
    if band not in KERNEL_BANDS:
        raise ValueError(
            f"stats kernel supports band 128, 256 or 512, got {band}")
    cells = 16 if band == 512 else 8
    if rows <= 0 or rows % cells:
        raise ValueError(f"stats kernel needs a positive multiple of {cells} "
                         f"rows at band {band}, got {rows}")


def band_dp_stats_ref(
    q: torch.Tensor, t: torch.Tensor, band: int, params: DPParams = DPParams()
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`band_dp_stats`: one Python iteration
    per read row over a ``(P, band)`` state on the inputs' device."""
    _check(q, t, band)
    P = q.shape[0]
    zeros = torch.zeros((2, P, band), dtype=torch.int32, device=q.device)
    best, (bm, bd), bqe, bte = _band_dp_rows(
        q, t, band, params,
        rider0=zeros,
        diag_step=lambda is_match: torch.stack(
            [is_match.to(torch.int32), torch.ones_like(zeros[0])]
        ),
        reset_rider=lambda i: zeros,
    )
    return {"score": best, "matches": bm, "n_diag": bd, "qe": bqe, "te": bte}


def _launch(q: torch.Tensor, t: torch.Tensor, band: int,
            params: DPParams) -> torch.Tensor:
    from . import build

    global launches
    P, M = q.shape
    check_kernel_shape(band, M)
    if not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("stats kernel needs contiguous q/t")
    lib = build.load_library()
    out = torch.empty((P, 8), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.band_dp_stats_launch(
            q.data_ptr(), t.data_ptr(), out.data_ptr(), P, M, band,
            params.match, params.mismatch, params.open_extend,
            params.gap_extend, stream,
        )
    build.check(lib, rc, "band_dp_stats kernel launch")
    launches += 1
    return out


def band_dp_stats(
    q: torch.Tensor,  # (P, M) int8 read windows, sentinel 4 beyond each read
    t: torch.Tensor,  # (P, M + band) int8 target windows, sentinel 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Per problem score, matches, n_diag, qe, te, int32 each.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    _check(q, t, band)
    if q.device.type == "cpu":
        return band_dp_stats_ref(q, t, band, params)
    if q.device.type != "cuda":
        raise ValueError(f"band_dp_stats: unsupported device {q.device}")
    out = _launch(q, t, band, params)
    return {name: out[:, c] for c, name in enumerate(STATS_COLS)}


def pack_pieces(q_start, t_start, m, t_lo, t_hi) -> np.ndarray:
    """The (5, P) int32 piece table of :data:`PIECE_ROWS` from int64 columns;
    raises ValueError where a value leaves int32 (the kernel's offsets)."""
    cols = np.stack([np.asarray(c, dtype=np.int64)
                     for c in (q_start, t_start, m, t_lo, t_hi)])
    info = np.iinfo(np.int32)
    if cols.size and (cols.min() < info.min or cols.max() > info.max):
        raise ValueError("a piece offset leaves int32: the fused-fetch stats "
                         "kernel addresses reads2 and panel_padded in int32")
    return cols.astype(np.int32)


def _launch_flat(reads2, panel_padded, vecs, bucket: int, band: int,
                 params: DPParams) -> torch.Tensor:
    from . import build

    global launches
    check_kernel_shape(band, bucket)
    q_start, t_start, m, t_lo, t_hi = vecs
    P = q_start.shape[0]
    lib = build.load_library()
    out = torch.empty((P, 8), dtype=torch.int32, device=reads2.device)
    with torch.cuda.device(reads2.device):
        stream = torch.cuda.current_stream(reads2.device).cuda_stream
        rc = lib.band_dp_stats_flat_launch(
            reads2.data_ptr(), reads2.shape[0], panel_padded.data_ptr(),
            panel_padded.shape[0], q_start.data_ptr(), t_start.data_ptr(),
            m.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), out.data_ptr(),
            P, bucket, band, params.match, params.mismatch,
            params.open_extend, params.gap_extend, stream,
        )
    build.check(lib, rc, "band_dp_stats_flat kernel launch")
    launches += 1
    return out


def band_dp_stats_flat(
    reads2: torch.Tensor,  # int8 (2N + pad,): fwd ++ revcomp ++ sentinel pad
    panel_padded: torch.Tensor,  # int8, sentinel-padded both ends
    pieces: torch.Tensor,  # (5, P) int32, rows PIECE_ROWS
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Per piece score, matches, n_diag, qe, te, int32 each, of the stats DP
    over ``bucket`` read rows ``reads2[q_start + i]`` (4 at ``i >= m``) and
    the target ``panel_padded[t_start + j]`` (4 outside ``[t_lo, t_hi)``):
    :func:`band_dp_stats` of :func:`gather_windows`' windows.

    CUDA tensors launch the kernel; CPU tensors gather the windows and take
    the plain version.
    """
    if pieces.dim() != 2 or pieces.shape[0] != len(PIECE_ROWS):
        raise TypeError(f"pieces must be ({len(PIECE_ROWS)}, P), rows "
                        f"{PIECE_ROWS}")
    vecs = tuple(pieces)
    check_flat_inputs(reads2, panel_padded, vecs)
    if not all(x.is_contiguous() for x in (reads2, panel_padded, pieces)):
        raise ValueError("band_dp_stats_flat needs contiguous inputs")
    check_rider(bucket)
    if reads2.device.type == "cpu":
        q_start, t_start, m, t_lo, t_hi = vecs
        q, t = gather_windows(reads2, panel_padded, q_start, m, t_start,
                              t_lo, t_hi, bucket, band)
        return band_dp_stats_ref(q, t, band, params)
    if reads2.device.type != "cuda":
        raise ValueError(f"band_dp_stats_flat: unsupported device "
                         f"{reads2.device}")
    out = _launch_flat(reads2, panel_padded, vecs, bucket, band, params)
    return {name: out[:, c] for c, name in enumerate(STATS_COLS)}
