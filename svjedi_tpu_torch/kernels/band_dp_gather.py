"""The gather engine's one-pass DP (G1): score, starts and ends.

PyTorch counterpart of ``svjedi_tpu/align/extend.py:band_dp_batch`` (a
jitted ``lax.scan`` in the JAX package, not a Pallas kernel): the DP of
``engine="gather"`` and of the count step's ``xla`` engine. Inputs keep the
JAX layout: read windows ``q (P, M)`` and target windows ``t (P, M +
band)``, int8 with sentinel 4. Per problem it returns the best score, the
start ``(qs, ts)`` of the optimal path ending at the end ``(qe, te)``: the
first row whose maximum beats the best, then the lowest band offset in that
row. A problem scoring 0 reports ``[0, 0, 0, -1, -1]``.

:func:`band_dp_gather` launches the hand-written CUDA kernel
(``csrc/band_dp_gather.cu``, entry ``band_dp_gather_launch``, on the
one-pass body of ``csrc/band_dp_body.cuh``) on CUDA tensors and takes
:func:`band_dp_gather_ref`, its plain PyTorch version (the row loop of
``align/extend.py``), on CPU tensors; any other device raises. On the card
the kernel takes bands 128, 256 and 512, rows in blocks of its cells per
lane, and windows its packed start ``qs << 16 | ts`` can hold (``M <
32768``, ``M + band < 65536``); it raises on anything else.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..align.extend import DPParams, band_dp_starts
from .band_dp import check_packing, check_windows

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0

#: Per-problem outputs, in the kernel's column order.
GATHER_COLS = ("score", "qs", "ts", "qe", "te")
#: Bands the kernel builds: K4's two layouts and A1's 32 lanes x 16 cells.
KERNEL_BANDS = (128, 256, 512)


def check_kernel_shape(band: int, rows: int) -> None:
    """The kernel's builds: band 128, 256 or 512, rows in blocks of its
    cells per lane (8; 16 at band 512), windows the packed start holds."""
    if band not in KERNEL_BANDS:
        raise ValueError(
            f"gather kernel supports band 128, 256 or 512, got {band}")
    cells = 16 if band == 512 else 8
    if rows <= 0 or rows % cells:
        raise ValueError(f"gather kernel needs a positive multiple of {cells} "
                         f"rows at band {band}, got {rows}")
    check_packing(rows, band)


def band_dp_gather_ref(
    q: torch.Tensor, t: torch.Tensor, band: int, params: DPParams = DPParams()
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`band_dp_gather`: one Python iteration
    per read row over a ``(P, band)`` state on the inputs' device."""
    check_windows(q, t, band)
    return band_dp_starts(q, t, band, params)


def _launch(q: torch.Tensor, t: torch.Tensor, band: int,
            params: DPParams) -> torch.Tensor:
    from . import build

    global launches
    P, M = q.shape
    check_kernel_shape(band, M)
    if not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("gather kernel needs contiguous q/t")
    lib = build.load_library()
    out = torch.empty((P, 8), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.band_dp_gather_launch(
            q.data_ptr(), t.data_ptr(), out.data_ptr(), P, M, band,
            params.match, params.mismatch, params.open_extend,
            params.gap_extend, stream,
        )
    build.check(lib, rc, "band_dp_gather kernel launch")
    launches += 1
    return out


def band_dp_gather(
    q: torch.Tensor,  # (P, M) int8 read windows, sentinel 4 beyond each read
    t: torch.Tensor,  # (P, M + band) int8 target windows, sentinel 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Per problem score, qs, ts, qe, te (window coordinates), int32 each.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    check_windows(q, t, band)
    if q.device.type == "cpu":
        return band_dp_starts(q, t, band, params)
    if q.device.type != "cuda":
        raise ValueError(f"band_dp_gather: unsupported device {q.device}")
    out = _launch(q, t, band, params)
    return {name: out[:, c] for c, name in enumerate(GATHER_COLS)}
