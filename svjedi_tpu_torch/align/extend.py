"""Banded affine-gap local alignment with match statistics (the audit DP).

PyTorch counterpart of ``svjedi_tpu/align/extend.py``. Only what the ``run``
path needs lives here: the scoring constants and :func:`band_dp_stats_batch`,
the audit re-score of winning spans. It is plain PyTorch (a Python loop over
read rows, each row one set of tensor ops over ``(P, band)``) on whichever
device its inputs lie; the JAX version is an XLA ``lax.scan``, not a Pallas
kernel.

The horizontal-gap closure is a prefix max instead of the JAX log-shift
cascade. Because every cell is floored at 0, for ``k >= 1``

    F[k] = max_{j<k} (htmp[j] + oe + ext*(k-1-j))
         = ext*k + max_{j<k} (htmp[j] + oe - ext*(j+1))

exactly in integers, and the cascade's strict ``>`` keeps, among tied
sources, the one nearest to ``k`` (the largest ``j``). Packing ``j`` into
the low bits of the prefix-max key reproduces that choice, so the statistics
that ride along are the cascade's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
    """a[:, k] <- a[:, k+1], ``fill`` in the last column."""
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def band_dp_stats_batch(
    q: torch.Tensor,  # (P, M) int8 read windows, padded with 4 (N)
    t: torch.Tensor,  # (P, M + band) int8 target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, torch.Tensor]:
    """Banded local alignment tracking exact-match statistics.

    Cell (i, k) pairs read position i with target-window position i + k.
    Returns per problem the best score, its end ``(qe, te)``, and along the
    optimal path ending there the exact base matches (``matches``) and the
    diagonal steps (``n_diag``); ties break as in the JAX version.
    """
    P, M = q.shape
    B = band
    dev = q.device
    oe = params.open_extend
    ext = params.gap_extend
    i32 = torch.int32

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
    mh = torch.zeros_like(H)
    dh = torch.zeros_like(H)
    mv = torch.zeros_like(H)
    dv = torch.zeros_like(H)
    best = torch.zeros(P, dtype=i32, device=dev)
    bm = torch.zeros_like(best)
    bd = torch.zeros_like(best)
    bqe = torch.full((P,), -1, dtype=i32, device=dev)
    bte = torch.full((P,), -1, dtype=i32, device=dev)

    for i in range(M):
        trow = t32[:, i : i + B]
        qi = q32[:, i : i + 1]
        is_match = (qi == trow) & (qi < 4)
        sub = is_match.to(i32) * (params.match - params.mismatch) + params.mismatch

        # Vertical gap: parents at k+1; gap bases add no match/diag step.
        v_open = _shift_left(H, NEG) + oe
        v_ext = _shift_left(V, NEG) + ext
        V_new = torch.maximum(v_open, v_ext)
        take_open = v_open >= v_ext
        mv_new = torch.where(take_open, _shift_left(mh, 0), _shift_left(mv, 0))
        dv_new = torch.where(take_open, _shift_left(dh, 0), _shift_left(dv, 0))

        diag = H + sub
        htmp = torch.maximum(diag, V_new)
        take_diag = diag >= V_new
        m_t = torch.where(take_diag, mh + is_match.to(i32), mv_new)
        d_t = torch.where(take_diag, dh + 1, dv_new)
        reset = htmp <= 0
        htmp = htmp.clamp_min(0)
        m_t = m_t.masked_fill(reset, 0)
        d_t = d_t.masked_fill(reset, 0)

        # Horizontal gap runs: exclusive prefix max over sources j < k.
        key = torch.cummax(htmp.to(torch.int64) * B + key_bias, dim=1).values
        prev = torch.cat([key_floor, key[:, :-1]], dim=1)
        src = torch.remainder(prev, B)
        F = (torch.div(prev - src, B, rounding_mode="floor") + ext_k).to(i32)
        take_f = (F > htmp) & (k_idx > 0)
        H_new = torch.where(take_f, F, htmp)
        mh_new = torch.where(take_f, torch.gather(m_t, 1, src), m_t)
        dh_new = torch.where(take_f, torch.gather(d_t, 1, src), d_t)

        # Track the global best end per problem (first column among ties).
        row_best = H_new.max(dim=1).values
        row_arg = torch.where(
            H_new == row_best[:, None], k_idx, B
        ).min(dim=1).values
        improved = row_best > best
        pick = row_arg[:, None].to(torch.int64)
        best = torch.where(improved, row_best, best)
        bm = torch.where(improved, torch.gather(mh_new, 1, pick)[:, 0], bm)
        bd = torch.where(improved, torch.gather(dh_new, 1, pick)[:, 0], bd)
        bqe = torch.where(improved, i, bqe)
        bte = torch.where(improved, i + row_arg, bte)

        H, V, mh, dh, mv, dv = H_new, V_new, mh_new, dh_new, mv_new, dv_new

    return {
        "score": best,
        "matches": bm,
        "n_diag": bd,
        "qe": bqe,
        "te": bte,
    }
