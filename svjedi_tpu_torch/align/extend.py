"""Banded affine-gap local alignment, batched (the extend stage), on PyTorch.

PyTorch counterpart of ``svjedi_tpu/align/extend.py``: the scoring
constants, :func:`band_dp_batch` (the one-pass DP of the ``gather`` engine,
which reports starts and ends), :func:`band_dp_stats_batch` (the audit
re-score of winning spans, which reports match statistics) and the exact
O(mn) oracle :func:`smith_waterman_full`. The JAX versions of the two DPs
are XLA ``lax.scan`` loops, not Pallas kernels; here each goes through a
CUDA kernel on a card and its plain version on the CPU:
``band_dp_batch`` through ``kernels/band_dp_gather.py`` (G1),
``band_dp_stats_batch`` through ``kernels/band_dp_stats.py`` (A1). A plain
version is one Python iteration per read row, each row one set of tensor
ops over ``(P, band)``.

The two share one row loop (:func:`_band_dp_rows`); they differ only in what
rides along each cell's optimal path. The horizontal-gap closure is a prefix
max instead of the JAX log-shift cascade. Because every cell is floored at
0, for ``k >= 1``

    F[k] = max_{j<k} (htmp[j] + oe + ext*(k-1-j))
         = ext*k + max_{j<k} (htmp[j] + oe - ext*(j+1))

exactly in integers, and the cascade's strict ``>`` keeps, among tied
sources, the one nearest to ``k`` (the largest ``j``). Packing ``j`` into
the low bits of the prefix-max key reproduces that choice, so the riders
are the cascade's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

NEG = -(1 << 30)


@dataclass(frozen=True)
class DPParams:
    match: int = 2
    mismatch: int = -4
    gap_open: int = -4  # charged on the first gap base together with extend
    gap_extend: int = -2

    @property
    def open_extend(self) -> int:
        return self.gap_open + self.gap_extend


def _shift_left(a: torch.Tensor, fill: int) -> torch.Tensor:
    """a[..., k] <- a[..., k+1], ``fill`` in the last column."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], fill)], dim=-1)


def _band_dp_rows(
    q: torch.Tensor,
    t: torch.Tensor,
    band: int,
    params: DPParams,
    rider0: torch.Tensor,
    diag_step: Optional[Callable[[torch.Tensor], torch.Tensor]],
    reset_rider: Callable[[int], torch.Tensor],
    per_cell: bool = False,
):
    """The row loop of :func:`band_dp_batch` and :func:`band_dp_stats_batch`.

    ``rider0`` is an ``(R, P, band)`` int32 stack of per-cell values carried
    along the optimal path (the same start for the H and V states);
    ``diag_step(is_match)`` is what a diagonal step adds to them (None: nothing)
    and ``reset_rider(i)`` what a cell that resets to 0 at row ``i`` takes.
    Returns (best, riders at the best cell (R, P), qe, te). The best end is
    the first row reaching the best score, and within that row the lowest
    band offset among its maxima; with ``per_cell`` (the one-pass kernels'
    rule) each band cell keeps the first row reaching its own best, and the
    lowest band offset among the cells at the maximum wins.
    """
    P, M = q.shape
    B = band
    dev = q.device
    oe = params.open_extend
    ext = params.gap_extend
    i32 = torch.int32
    R = rider0.shape[0]

    q32 = q.to(i32)
    t32 = t.to(i32)
    k_idx = torch.arange(B, device=dev, dtype=i32).expand(P, B)
    j64 = torch.arange(B, device=dev, dtype=torch.int64)
    # Prefix-max key of source j: its F contribution (minus ext*k) shifted
    # past the bits of j, so the max is the largest j among tied values.
    key_bias = (oe - ext * (j64 + 1)) * B + j64
    key_floor = torch.full((P, 1), NEG * B, dtype=torch.int64, device=dev)
    ext_k = ext * k_idx

    H = torch.zeros((P, B), dtype=i32, device=dev)
    V = torch.full((P, B), NEG, dtype=i32, device=dev)
    rh = rider0.clone()
    rv = rider0.clone()
    shape = (P, B) if per_cell else (P,)
    best = torch.zeros(shape, dtype=i32, device=dev)
    brider = torch.zeros((R, *shape), dtype=i32, device=dev)
    bqe = torch.full(shape, -1, dtype=i32, device=dev)
    bte = torch.full((P,), -1, dtype=i32, device=dev)

    for i in range(M):
        trow = t32[:, i : i + B]
        qi = q32[:, i : i + 1]
        is_match = (qi == trow) & (qi < 4)
        sub = is_match.to(i32) * (params.match - params.mismatch) + params.mismatch

        # Vertical gap: parents at k+1.
        v_open = _shift_left(H, NEG) + oe
        v_ext = _shift_left(V, NEG) + ext
        V_new = torch.maximum(v_open, v_ext)
        rv_new = torch.where(v_open >= v_ext, _shift_left(rh, 0), _shift_left(rv, 0))

        # Diagonal + vertical + reset-to-zero.
        diag = H + sub
        htmp = torch.maximum(diag, V_new)
        r_diag = rh if diag_step is None else rh + diag_step(is_match)
        r_t = torch.where(diag >= V_new, r_diag, rv_new)
        reset = htmp <= 0
        htmp = htmp.clamp_min(0)
        r_t = torch.where(reset, reset_rider(i), r_t)

        # Horizontal gap runs: exclusive prefix max over sources j < k.
        key = torch.cummax(htmp.to(torch.int64) * B + key_bias, dim=1).values
        prev = torch.cat([key_floor, key[:, :-1]], dim=1)
        src = torch.remainder(prev, B)
        F = (torch.div(prev - src, B, rounding_mode="floor") + ext_k).to(i32)
        take_f = (F > htmp) & (k_idx > 0)
        H_new = torch.where(take_f, F, htmp)
        rh_new = torch.where(
            take_f, torch.gather(r_t, 2, src.expand(R, P, B)), r_t
        )

        H, V, rh, rv = H_new, V_new, rh_new, rv_new
        if per_cell:
            improved = H > best
            best = torch.where(improved, H, best)
            brider = torch.where(improved, rh, brider)
            bqe = torch.where(improved, i, bqe)
            continue

        # Track the global best end per problem (first column among ties).
        row_best = H_new.max(dim=1).values
        row_arg = torch.where(H_new == row_best[:, None], k_idx, B).min(dim=1).values
        improved = row_best > best
        pick = row_arg.to(torch.int64).expand(R, 1, P).transpose(1, 2)
        best = torch.where(improved, row_best, best)
        brider = torch.where(improved, torch.gather(rh_new, 2, pick)[:, :, 0], brider)
        bqe = torch.where(improved, i, bqe)
        bte = torch.where(improved, i + row_arg, bte)

    if per_cell:
        cell_best = best
        best = cell_best.max(dim=1).values
        lane = torch.where(cell_best == best[:, None], k_idx, B).min(dim=1).values
        pick = lane.to(torch.int64)[:, None]
        brider = torch.gather(brider, 2, pick.expand(R, P, 1))[:, :, 0]
        bqe = torch.gather(bqe, 1, pick)[:, 0]
        bte = bqe + lane
    return best, brider, bqe, bte


def band_dp_starts(
    q: torch.Tensor,  # (P, M) read windows, padded with 4 (N)
    t: torch.Tensor,  # (P, M + band) target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
    per_cell: bool = False,
) -> Dict[str, torch.Tensor]:
    """The plain row loop with starts riding along: :func:`band_dp_batch`'s
    contract (the plain version of the kernel G1), or with ``per_cell`` the
    one-pass kernels' end among tied optima (K3/K4's plain version,
    ``kernels/band_dp.py``)."""
    P = q.shape[0]
    dev = q.device
    k_idx = torch.arange(band, device=dev, dtype=torch.int32).expand(P, band)
    # A fresh alignment's first aligned cell is the diagonal successor (i+1, k).
    best, (bqs, bts), bqe, bte = _band_dp_rows(
        q, t, band, params,
        rider0=torch.stack([torch.zeros_like(k_idx), k_idx]),
        diag_step=None,
        reset_rider=lambda i: torch.stack(
            [torch.full_like(k_idx, i + 1), k_idx + (i + 1)]
        ),
        per_cell=per_cell,
    )
    return {"score": best, "qs": bqs, "ts": bts, "qe": bqe, "te": bte}


def band_dp_batch(
    q: torch.Tensor,  # (P, M) int8 read windows, padded with 4 (N)
    t: torch.Tensor,  # (P, M + band) int8 target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
    per_cell: bool = False,
) -> Dict[str, torch.Tensor]:
    """Batched banded local alignment (the one-pass ``gather`` engine).

    Cell (i, k) pairs read position i with target-window position j = i + k
    (the caller centres the band by slicing the target at d0 - band//2).
    Returns per problem the best score and the inclusive window coordinates
    of the alignment span: ``qs/qe`` (read) and ``ts/te`` (target window).
    A problem scoring 0 reports ``qs = ts = 0`` and ``qe = te = -1``. CUDA
    tensors launch the kernel G1, CPU tensors take its plain version
    (``kernels/band_dp_gather.py``). ``per_cell`` picks the one-pass
    kernels' end among tied optima instead, always in the plain row loop:
    it is K4's plain version (``kernels/band_dp.py``), never a kernel.
    """
    if per_cell:
        return band_dp_starts(q, t, band, params, per_cell=True)
    from ..kernels.band_dp_gather import band_dp_gather

    return band_dp_gather(q, t, band, params)


def band_dp_stats_batch(
    q: torch.Tensor,  # (P, M) int8 read windows, padded with 4 (N)
    t: torch.Tensor,  # (P, M + band) int8 target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Banded local alignment tracking exact-match statistics.

    Same band semantics as :func:`band_dp_batch`. Returns per problem the
    best score, its end ``(qe, te)``, and along the optimal path ending there
    the exact base matches (``matches``) and the diagonal steps
    (``n_diag``); ties break as in the JAX version. CUDA tensors launch the
    kernel A1, CPU tensors take its plain version
    (``kernels/band_dp_stats.py``).
    """
    from ..kernels.band_dp_stats import band_dp_stats

    return band_dp_stats(q, t, band, params)


# Copied verbatim from svjedi_tpu/align/extend.py:smith_waterman_full.
def smith_waterman_full(
    q: np.ndarray, t: np.ndarray, params: DPParams = DPParams()
) -> Tuple[int, int, int, int, int]:
    """Exact O(mn) local affine alignment (tests only).

    Returns (score, qs, ts, qe, te), end coordinates inclusive.
    """
    m, n = len(q), len(t)
    oe, ext = params.open_extend, params.gap_extend
    H = np.zeros((n + 1,), dtype=np.int64)
    E = np.full((n + 1,), NEG, dtype=np.int64)  # horizontal (gap in t)
    F = np.full((n + 1,), NEG, dtype=np.int64)  # vertical
    SH = [(0, j) for j in range(n + 1)]  # start of alignment ending here
    SE = [(0, 0)] * (n + 1)
    SF = [(0, 0)] * (n + 1)
    best = (0, 0, 0, -1, -1)
    for i in range(m):
        H_prev = H.copy()
        SH_prev = list(SH)
        H[0] = 0
        SH[0] = (i + 1, 0)
        for j in range(1, n + 1):
            sub = (
                params.match
                if (q[i] == t[j - 1] and q[i] < 4)
                else params.mismatch
            )
            e_open, e_ext = H[j - 1] + oe, E[j - 1] + ext
            E[j] = max(e_open, e_ext)
            SE[j] = SH[j - 1] if e_open >= e_ext else SE[j - 1]
            f_open, f_ext = H_prev[j] + oe, F[j] + ext
            new_F = max(f_open, f_ext)
            SF[j] = SH_prev[j] if f_open >= f_ext else SF[j]
            F[j] = new_F
            diag = H_prev[j - 1] + sub
            h = max(0, diag, E[j], new_F)
            if h == 0:
                SH[j] = (i + 1, j)  # next diagonal consumer starts there
            elif h == diag:
                SH[j] = SH_prev[j - 1]
            elif h == new_F:
                SH[j] = SF[j]
            else:
                SH[j] = SE[j]
            H[j] = h
            if h > best[0]:
                best = (int(h), SH[j][0], SH[j][1], i, j - 1)
    return best
