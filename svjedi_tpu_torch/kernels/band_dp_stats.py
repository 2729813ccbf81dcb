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
"""

from __future__ import annotations

from typing import Dict

import torch

from ..align.extend import DPParams, _band_dp_rows
from .band_dp import check_windows

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0

#: Per-problem outputs, in the kernel's column order.
STATS_COLS = ("score", "matches", "n_diag", "qe", "te")
#: Bands the kernel builds: K4's two layouts and 32 lanes x 16 cells.
KERNEL_BANDS = (128, 256, 512)


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
