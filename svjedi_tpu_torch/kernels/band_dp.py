"""One-pass banded DP on pre-gathered windows (score, starts and ends).

PyTorch counterpart of ``svjedi_tpu/kernels/band_dp.py`` (``band_dp_pallas``).
Inputs keep the JAX layout: read windows ``q (P, M)`` and target windows
``t (P, M + band)``, int8 with sentinel 4; the result is that of running
every one of the ``M`` rows, as the plain version does.

The contract is the TPU kernel's, which differs from ``band_dp_batch`` on
ties: each band cell keeps the first row at which it reaches its best
(strict ``>``), and among the cells tied at the maximum the lowest band
offset wins. Starts ride along packed as ``qs << 16 | ts``, so ``M < 32768``
and ``M + band < 65536``. A problem scoring 0 reports ``[0, 0, 0, -1, -1]``.

:func:`band_dp_onepass` launches the hand-written CUDA kernel
(``csrc/band_dp_onepass.cu``, entry ``band_dp_onepass_launch``) on CUDA
tensors and takes :func:`band_dp_onepass_ref`, its plain PyTorch version, on
CPU tensors; any other device raises. The fused-fetch variant
(``kernels/band_dp_dma.py``) runs the same DP body.

Trailing sentinel rows. The one-pass kernels skip a problem's rows past its
last read code other than 4 (K3: past ``m``) only where
:func:`rows_skip_exact` holds; otherwise every row runs.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..align.device import OUT_COLS
from ..align.extend import DPParams, band_dp_batch

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0


def check_packing(rows: int, band: int) -> None:
    """Raise where packed starts ``qs << 16 | ts`` cannot hold the windows."""
    if not (0 <= rows < (1 << 15) and rows + band < (1 << 16)):
        raise ValueError(
            f"packed starts need rows < 32768 and rows + band < 65536 "
            f"(got rows={rows}, band={band})"
        )


def check_kernel_band(band: int) -> None:
    if band not in (128, 256):
        raise ValueError(f"one-pass kernel supports band 128 or 256, got {band}")


def check_kernel_rows(rows: int) -> None:
    """The kernels run rows in blocks of 8 (the JAX kernels take multiples
    of 128)."""
    if rows % 8:
        raise ValueError(
            f"one-pass kernel needs a multiple of 8 rows, got {rows}")


def rows_skip_exact(params: DPParams) -> bool:
    """Whether trailing sentinel read rows cannot change the result, so the
    one-pass kernels may skip them: ``rows_skip_exact`` in
    ``csrc/band_dp_common.cuh``, which the launchers evaluate and whose
    comment says why."""
    return (params.mismatch <= 0 and params.open_extend < 0
            and params.gap_extend <= 0)


def onepass_plain(
    q: torch.Tensor, t: torch.Tensor, band: int, params: DPParams
) -> torch.Tensor:
    """The kernels' contract in plain PyTorch: (P, 5) int32 per OUT_COLS.

    ``band_dp_batch``'s row loop (one Python iteration per read row over a
    ``(P, band)`` state on the inputs' device) with the kernels' per-cell
    choice among tied optima.
    """
    res = band_dp_batch(q, t, band, params, per_cell=True)
    return torch.stack([res[c] for c in OUT_COLS], dim=1)


def check_windows(q: torch.Tensor, t: torch.Tensor, band: int) -> None:
    """Raise unless q and t are the pre-gathered entries' windows: int8
    ``(P, M)`` and ``(P, M + band)`` on one device."""
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be 2-D (P, M) and (P, M + band)")
    P, M = q.shape
    if t.shape != (P, M + band):
        raise ValueError(
            f"expected t ({P}, {M + band}) for q {tuple(q.shape)}, got "
            f"{tuple(t.shape)}"
        )
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"q/t must be int8, got {q.dtype}/{t.dtype}")
    if q.device != t.device:
        raise ValueError(f"q on {q.device} but t on {t.device}")


def _check(q: torch.Tensor, t: torch.Tensor, band: int) -> None:
    check_windows(q, t, band)
    check_packing(q.shape[1], band)


def _as_dict(out: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: out[:, c] for c, name in enumerate(OUT_COLS)}


def band_dp_onepass_ref(
    q: torch.Tensor, t: torch.Tensor, band: int, params: DPParams = DPParams()
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`band_dp_onepass`."""
    _check(q, t, band)
    return _as_dict(onepass_plain(q, t, band, params))


def _launch(q: torch.Tensor, t: torch.Tensor, band: int, params: DPParams):
    from . import build

    global launches
    check_kernel_band(band)
    P, M = q.shape
    check_kernel_rows(M)
    if not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("one-pass kernel needs contiguous q/t")
    lib = build.load_library()
    out = torch.empty((P, 8), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.band_dp_onepass_launch(
            q.data_ptr(), t.data_ptr(), out.data_ptr(), P, M, band,
            params.match, params.mismatch, params.open_extend,
            params.gap_extend, stream,
        )
    build.check(lib, rc, "band_dp_onepass kernel launch")
    launches += 1
    return out


def band_dp_onepass(
    q: torch.Tensor,  # (P, M) int8 read windows, sentinel 4 beyond each read
    t: torch.Tensor,  # (P, M + band) int8 target windows, sentinel 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Per problem score, qs, ts, qe, te (window coordinates), int32 each.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    _check(q, t, band)
    if q.device.type == "cpu":
        return _as_dict(onepass_plain(q, t, band, params))
    if q.device.type != "cuda":
        raise ValueError(f"band_dp_onepass: unsupported device {q.device}")
    return _as_dict(_launch(q, t, band, params))
