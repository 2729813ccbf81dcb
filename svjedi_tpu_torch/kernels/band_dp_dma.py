"""One-pass banded DP that fetches its own windows from the flat buffers.

PyTorch counterpart of ``svjedi_tpu/kernels/band_dp_dma.py``
(``band_dp_dma_raw`` and ``band_dp_dma``). Inputs are the upload's flat
int8 buffers (``align/device.py``: ``reads2`` = fwd ++ revcomp ++ sentinel
pad, ``panel_padded`` = pad ++ paths ++ pad) and five (P,) int32 vectors per
problem: the read-window start ``q_start`` and length ``m``, the target
window's lane-0 position ``t_start`` and the path's absolute bounds
``[t_lo, t_hi)``. Problem p aligns ``bucket`` read rows ``reads2[q_start +
i]`` (sentinel 4 at ``i >= m``) against ``panel_padded[t_start + i + k]``
(sentinel 4 outside ``[t_lo, t_hi)``), with the DP and tie rule of
``kernels/band_dp.py``. Bytes outside a buffer read as 4; the upload's
padding keeps every real window inside. The kernel skips rows past ``m``
only where ``kernels/band_dp.py:rows_skip_exact`` holds; otherwise it runs
all ``bucket`` rows, as the plain version does.

:func:`band_dp_dma_raw` launches the hand-written CUDA kernel
(``csrc/band_dp_onepass.cu``, entry ``band_dp_dma_launch``) on CUDA tensors
and takes :func:`band_dp_dma_raw_ref`, its plain PyTorch version, on CPU
tensors; any other device raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..align.device import OUT_COLS, gather_windows
from ..align.extend import DPParams
from .band_dp import (check_kernel_band, check_kernel_rows, check_packing,
                      onepass_plain)

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0


def _check(reads2, panel_padded, vecs, bucket: int, band: int) -> None:
    check_flat_inputs(reads2, panel_padded, vecs)
    check_packing(bucket, band)


def check_flat_inputs(reads2, panel_padded, vecs) -> None:
    """Raise unless the flat buffers are 1-D int8 and the per-problem
    vectors (P,) int32, all on one device."""
    for name, buf in (("reads2", reads2), ("panel_padded", panel_padded)):
        if buf.dim() != 1 or buf.dtype != torch.int8:
            raise TypeError(f"{name} must be a 1-D int8 tensor")
    P = vecs[0].shape[0]
    for v in vecs:
        if v.shape != (P,) or v.dtype != torch.int32:
            raise TypeError("q_start/t_start/m/t_lo/t_hi must be (P,) int32")
    if any(x.device != reads2.device for x in (panel_padded, *vecs)):
        raise ValueError("buffers and vectors must lie on one device")


def band_dp_dma_raw_ref(
    reads2: torch.Tensor,
    panel_padded: torch.Tensor,
    q_start: torch.Tensor,
    t_start: torch.Tensor,
    m: torch.Tensor,
    t_lo: torch.Tensor,
    t_hi: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
) -> torch.Tensor:
    """Plain PyTorch version: gather the windows, run all ``bucket`` rows."""
    _check(reads2, panel_padded, (q_start, t_start, m, t_lo, t_hi), bucket, band)
    q, t = gather_windows(
        reads2, panel_padded, q_start, m, t_start, t_lo, t_hi, bucket, band
    )
    out = onepass_plain(q, t, band, params)
    return torch.cat([out, torch.zeros_like(out[:, :3])], dim=1)


def _launch(reads2, panel_padded, vecs, bucket: int, band: int,
            params: DPParams) -> torch.Tensor:
    from . import build

    global launches
    check_kernel_band(band)
    check_kernel_rows(bucket)
    if not all(x.is_contiguous() for x in (reads2, panel_padded, *vecs)):
        raise ValueError("band_dp_dma kernel needs contiguous inputs")
    q_start, t_start, m, t_lo, t_hi = vecs
    P = q_start.shape[0]
    lib = build.load_library()
    out = torch.zeros((P, 8), dtype=torch.int32, device=reads2.device)
    with torch.cuda.device(reads2.device):
        stream = torch.cuda.current_stream(reads2.device).cuda_stream
        rc = lib.band_dp_dma_launch(
            reads2.data_ptr(), reads2.shape[0], panel_padded.data_ptr(),
            panel_padded.shape[0], q_start.data_ptr(), t_start.data_ptr(),
            m.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), out.data_ptr(),
            P, bucket, band, params.match, params.mismatch,
            params.open_extend, params.gap_extend, stream,
        )
    build.check(lib, rc, "band_dp_dma kernel launch")
    launches += 1
    return out


def band_dp_dma_raw(
    reads2: torch.Tensor,  # int8 (2N + pad,): fwd ++ revcomp ++ sentinel pad
    panel_padded: torch.Tensor,  # int8, sentinel-padded both ends
    q_start: torch.Tensor,  # (P,) int32 window start in reads2
    t_start: torch.Tensor,  # (P,) int32 window lane-0 in panel_padded
    m: torch.Tensor,  # (P,) int32 read-window length
    t_lo: torch.Tensor,  # (P,) int32 first valid panel_padded index of the path
    t_hi: torch.Tensor,  # (P,) int32 one-past-last valid index
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
) -> torch.Tensor:
    """(P, 8) int32 ``[score, qs, ts, qe, te, 0, 0, 0]`` in window coordinates.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    vecs = (q_start, t_start, m, t_lo, t_hi)
    _check(reads2, panel_padded, vecs, bucket, band)
    if reads2.device.type == "cpu":
        return band_dp_dma_raw_ref(
            reads2, panel_padded, *vecs, bucket=bucket, band=band, params=params
        )
    if reads2.device.type != "cuda":
        raise ValueError(f"band_dp_dma: unsupported device {reads2.device}")
    return _launch(reads2, panel_padded, vecs, bucket, band, params)


def band_dp_dma(
    reads2: torch.Tensor,
    panel_padded: torch.Tensor,
    q_start: torch.Tensor,
    t_start: torch.Tensor,
    m: torch.Tensor,
    t_lo: torch.Tensor,
    t_hi: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """:func:`band_dp_dma_raw` as a dict of the five (P,) result columns."""
    out = band_dp_dma_raw(
        reads2, panel_padded, q_start, t_start, m, t_lo, t_hi,
        bucket=bucket, band=band, params=params,
    )
    return {name: out[:, c] for c, name in enumerate(OUT_COLS)}
