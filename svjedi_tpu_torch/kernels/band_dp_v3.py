"""Score-only banded DP (the v3 forward pass), its reverse pass and the two-pass wrapper.

PyTorch counterpart of ``svjedi_tpu/kernels/band_dp_v3.py``. The public
functions keep the JAX layout: transposed windows ``qT (bucket, P)`` and
``tT (bucket + band, P)`` int8 with sentinel 4, ``P % 128 == 0``, and the
``n_valid`` argument in every form the JAX version takes (None, an int, a
1-element tensor, or ``[n_valid] ++ per-128-problem row bounds``).

:func:`band_dp_v3_fwd` runs the hand-written CUDA kernel
(``csrc/band_dp_v3.cu``) on CUDA tensors and :func:`band_dp_v3_fwd_ref`,
its plain PyTorch version, on CPU tensors; any other device raises.
:func:`band_dp_v3_rev` runs the same kernel body's reverse build, which
reads each end-clamped window backwards from its last valid row and runs
only the rows the windows need (every row where the mismatch or a gap score
is positive); its plain version,
:func:`band_dp_v3_rev_ref`, is the forward pass on flipped windows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..align.extend import NEG, DPParams

#: Problems per row-bound group (the JAX kernel's grid step).
P_STEP = 128

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0
#: Of those, the launches of the reverse kernel (K1').
rev_launches = 0


def _check_shapes(qT: torch.Tensor, tT: torch.Tensor, bucket: int, band: int):
    P = qT.shape[1]
    if not (P % P_STEP == 0 and band % 128 == 0 and bucket % 8 == 0):
        raise ValueError(
            f"band_dp_v3 needs P % 128 == 0, band % 128 == 0 and "
            f"bucket % 8 == 0 (got P={P}, band={band}, bucket={bucket})"
        )
    if not (bucket < (1 << 15) and bucket + band < (1 << 16)):
        raise ValueError(f"bucket {bucket} out of range")
    if qT.shape != (bucket, P) or tT.shape != (bucket + band, P):
        raise ValueError(
            f"expected qT ({bucket}, {P}) and tT ({bucket + band}, {P}), got "
            f"{tuple(qT.shape)} and {tuple(tT.shape)}"
        )
    if qT.dtype != torch.int8 or tT.dtype != torch.int8:
        raise TypeError(f"qT/tT must be int8, got {qT.dtype}/{tT.dtype}")
    if qT.device != tT.device:
        raise ValueError(f"qT on {qT.device} but tT on {tT.device}")


def _prefetch(n_valid, P: int, bucket: int, device) -> torch.Tensor:
    """``[n_valid] ++ row bounds`` as int32 on ``device`` (bounds default to bucket)."""
    grid = P // P_STEP
    if n_valid is None:
        n_valid = P
    if isinstance(n_valid, torch.Tensor):
        nv = n_valid.to(device=device, dtype=torch.int32).reshape(-1)
    else:
        nv = torch.as_tensor(
            np.asarray(n_valid, dtype=np.int32).reshape(-1), device=device
        )
    if nv.shape[0] == 1 + grid:
        return nv.contiguous()
    return torch.cat(
        [nv[:1], torch.full((grid,), bucket, dtype=torch.int32, device=device)]
    )


def band_dp_v3_fwd_ref(
    qT: torch.Tensor,
    tT: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
    n_valid=None,
) -> torch.Tensor:
    """Plain PyTorch forward pass: (P, 3) int32 ``[score, qe, te]``.

    One Python iteration per read row over a ``(band, n_valid)`` state on the
    inputs' device. Problems at index >= n_valid are written (0, -1, -1).
    """
    _check_shapes(qT, tT, bucket, band)
    P = qT.shape[1]
    dev = qT.device
    B = band
    oe, ext = params.open_extend, params.gap_extend
    i32 = torch.int32
    prefetch = _prefetch(n_valid, P, bucket, dev).cpu().numpy()
    n = max(0, min(int(prefetch[0]), P))
    out = torch.full((P, 3), -1, dtype=i32, device=dev)
    out[:, 0] = 0
    if n == 0:
        return out
    bounds = prefetch[1:].astype(np.int64)
    rows_g = np.clip((bounds + 7) // 8 * 8, 0, bucket)
    rows_p = torch.as_tensor(np.repeat(rows_g, P_STEP)[:n], device=dev)
    n_rows = int(rows_g[: -(-n // P_STEP)].max())

    q = qT[:, :n].to(i32)
    t = tT[:, :n].to(i32)
    k = torch.arange(B, dtype=i32, device=dev)[:, None]
    gap_bias = oe - ext * (k + 1)  # F source weight of cell j
    ext_k = ext * k[1:]
    neg_row = torch.full((1, n), NEG, dtype=i32, device=dev)
    H = torch.zeros((B, n), dtype=i32, device=dev)
    V = torch.full((B, n), NEG, dtype=i32, device=dev)
    BEST = torch.zeros((B, n), dtype=i32, device=dev)
    BQE = torch.full((B, n), -1, dtype=i32, device=dev)
    for i in range(n_rows):
        qi = q[i]
        trow = t[i : i + B]
        sub = ((qi == trow) & (qi < 4)).to(i32) * (
            params.match - params.mismatch
        ) + params.mismatch
        h_up = torch.cat([H[1:], neg_row])
        v_up = torch.cat([V[1:], neg_row])
        V = torch.maximum(h_up + oe, v_up + ext)
        htmp = torch.maximum(H + sub, V).clamp_min(0)
        pre = torch.cummax(htmp + gap_bias, dim=0).values
        F = torch.cat([neg_row, pre[:-1] + ext_k])
        H = torch.maximum(htmp, F)
        improved = (H > BEST) & (i < rows_p)
        BEST = torch.where(improved, H, BEST)
        BQE = torch.where(improved, i, BQE)
    best = BEST.max(dim=0).values
    kstar = torch.where(BEST == best, k, B).min(dim=0).values
    qe = torch.gather(BQE, 0, kstar[None].to(torch.int64))[0]
    out[:n, 0] = best
    out[:n, 1] = qe
    out[:n, 2] = qe + kstar
    return out


def _launch(qT, tT, prefetch, bucket: int, band: int, params: DPParams,
            m=None):
    """Launch the forward kernel, or with ``m`` the reverse one (the
    launcher picks the build from the params)."""
    from . import build

    global launches, rev_launches
    if not (qT.is_contiguous() and tT.is_contiguous()):
        raise ValueError("band_dp_v3 kernel needs contiguous qT/tT")
    if band not in (128, 256):
        raise ValueError(f"band_dp_v3 kernel supports band 128 or 256, got {band}")
    if prefetch.device != qT.device:
        raise ValueError("prefetch vector on another device than qT")
    P = qT.shape[1]
    lib = build.load_library()
    out = torch.empty((P, 3), dtype=torch.int32, device=qT.device)
    args = (P, bucket, band, params.match, params.mismatch,
            params.open_extend, params.gap_extend)
    with torch.cuda.device(qT.device):
        stream = torch.cuda.current_stream(qT.device).cuda_stream
        if m is None:
            rc = lib.band_dp_v3_fwd_launch(
                qT.data_ptr(), tT.data_ptr(), prefetch.data_ptr(),
                out.data_ptr(), *args, stream,
            )
        else:
            rc = lib.band_dp_v3_rev_launch(
                qT.data_ptr(), tT.data_ptr(), prefetch.data_ptr(),
                m.data_ptr(), out.data_ptr(), *args, stream,
            )
    what = "band_dp_v3_fwd" if m is None else "band_dp_v3_rev"
    build.check(lib, rc, f"{what} kernel launch")
    launches += 1
    if m is not None:
        rev_launches += 1
    return out


def band_dp_v3_fwd(
    qT: torch.Tensor,  # (bucket, P) int8, sentinel 4 beyond each window
    tT: torch.Tensor,  # (bucket + band, P) int8, sentinel 4 outside path
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
    n_valid=None,
) -> torch.Tensor:
    """Forward pass: per problem (score, qe, te) — ends only; (P, 3) int32.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    _check_shapes(qT, tT, bucket, band)
    if qT.device.type == "cpu":
        return band_dp_v3_fwd_ref(qT, tT, bucket, band, params, n_valid)
    if qT.device.type != "cuda":
        raise ValueError(f"band_dp_v3_fwd: unsupported device {qT.device}")
    prefetch = _prefetch(n_valid, qT.shape[1], bucket, qT.device)
    return _launch(qT, tT, prefetch, bucket, band, params)


def band_dp_v3_rev_ref(
    qT: torch.Tensor,
    tT: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
    n_valid=None,
    fwd=band_dp_v3_fwd_ref,
) -> torch.Tensor:
    """Plain reverse pass: flip both windows, run the forward pass, map back.

    Flipping makes every end-clamped window suffix-aligned; leading sentinel
    rows cannot score, so the flipped problem's best END is the original's
    best START. ``fwd`` selects the forward implementation (the plain one by
    default). Row bounds in ``n_valid`` are not used: they would cut the
    flipped windows' valid rows, which come last.
    """
    _check_shapes(qT, tT, bucket, band)
    TW = bucket + band
    qT_r = torch.flip(qT, dims=(0,)).contiguous()
    # One extra row of flip-shift keeps the band offset k'' = B-1-k inside
    # [0, band); the wrapped row is never read (i''+k'' <= TW-2).
    tT_r = torch.roll(torch.flip(tT, dims=(0,)), -1, dims=0).contiguous()
    n_valid = _prefetch(n_valid, qT.shape[1], bucket, qT.device)[:1]
    out = fwd(qT_r, tT_r, bucket, band, params, n_valid)
    score = out[:, 0]
    qs = (bucket - 1) - out[:, 1]
    ts = (TW - 2) - out[:, 2]
    return torch.stack([score, qs, ts], dim=1)


def valid_rows(qT: torch.Tensor) -> torch.Tensor:
    """(P,) int32: 1 + the last row whose read code is not 4 (0 if none).

    Every row after it is sentinel, so this ``m`` is exact for any input."""
    bucket = qT.shape[0]
    rows = torch.arange(1, bucket + 1, dtype=torch.int16, device=qT.device)
    return torch.where(qT != 4, rows[:, None], 0).amax(dim=0).to(torch.int32)


def band_dp_v3_rev(
    qT: torch.Tensor,
    tT: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
    n_valid=None,
    m=None,
) -> torch.Tensor:
    """Reverse pass: per problem (score, qs, ts) — starts of an optimal
    alignment inside the (already end-clamped) windows; (0, bucket,
    bucket + band - 1) for a problem scoring 0 or at index >= n_valid.

    The caller must have masked qT beyond qe and tT beyond te. CUDA tensors
    launch the reverse kernel, which reads each window backwards from its
    row ``m - 1`` with no copy; ``m`` is the (P,) int32 count of valid read
    rows (``qe + 1``), derived by :func:`valid_rows` when None. Where the
    mismatch or a gap score is positive, a sentinel row can change H, so
    the kernel runs every row (``m = bucket`` for every problem, whatever
    the caller passed): its addresses are then exactly the flipped windows
    of :func:`band_dp_v3_rev_ref`. CPU tensors take
    :func:`band_dp_v3_rev_ref`. Row bounds in ``n_valid`` are not used.
    """
    _check_shapes(qT, tT, bucket, band)
    if qT.device.type == "cpu":
        return band_dp_v3_rev_ref(qT, tT, bucket, band, params, n_valid)
    if qT.device.type != "cuda":
        raise ValueError(f"band_dp_v3_rev: unsupported device {qT.device}")
    P = qT.shape[1]
    if max(params.mismatch, params.open_extend, params.gap_extend) > 0:
        m = torch.full((P,), bucket, dtype=torch.int32, device=qT.device)
    elif m is None:
        m = valid_rows(qT)
    if m.shape != (P,) or m.dtype != torch.int32 or m.device != qT.device:
        raise ValueError(f"m must be ({P},) int32 on {qT.device}")
    prefetch = _prefetch(n_valid, P, bucket, qT.device)  # bounds unread
    return _launch(qT, tT, prefetch, bucket, band, params, m=m.contiguous())


def band_dp_v3(
    qT: torch.Tensor,
    tT: torch.Tensor,
    bucket: int,
    band: int,
    params: DPParams = DPParams(),
    fwd=band_dp_v3_fwd,
) -> Dict[str, torch.Tensor]:
    """Two-pass wrapper returning the one-pass ``band_dp_batch`` contract.

    Production code runs the passes separately (the reverse pass only on
    winners); this wrapper exists for tests and checks. With the kernel's
    ``fwd`` the reverse pass is :func:`band_dp_v3_rev` (given m = qe + 1),
    otherwise :func:`band_dp_v3_rev_ref` over ``fwd``.
    """
    out = fwd(qT, tT, bucket, band, params)
    score, qe, te = out[:, 0], out[:, 1], out[:, 2]
    rows = torch.arange(bucket, dtype=torch.int32, device=qT.device)[:, None]
    qT2 = torch.where(rows <= qe[None, :], qT, 4).to(torch.int8)
    trows = torch.arange(bucket + band, dtype=torch.int32, device=qT.device)
    tT2 = torch.where(trows[:, None] <= te[None, :], tT, 4).to(torch.int8)
    if fwd is band_dp_v3_fwd:
        rev = band_dp_v3_rev(qT2, tT2, bucket, band, params, m=qe + 1)
    else:
        rev = band_dp_v3_rev_ref(qT2, tT2, bucket, band, params, fwd=fwd)
    return {
        "score": score,
        "qs": rev[:, 1],
        "ts": rev[:, 2],
        "qe": qe,
        "te": te,
        "score_rev": rev[:, 0],
    }
