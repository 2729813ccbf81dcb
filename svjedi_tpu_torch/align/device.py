"""Device-resident read/panel buffers and the v3 window prep, on PyTorch.

Counterpart of ``svjedi_tpu/align/device.py`` for the v3 engine. The buffer
layout is the JAX package's, byte for byte, so uploaded state can be
compared exactly:

- ``reads2`` = fwd codes ++ revcomp codes ++ sentinel bases. The forward
  half is padded with A (0) up to ``n_cap``, a power of two >= 4096;
  reverse-strand windows are addressed inside the rc half with positive
  stride (rc of read r with offsets [o_r, o_r+1) starts at 2N - o_{r+1}).
- ``panel_padded`` = pad ++ panel ++ pad with ``pad = max_window + 4*ALIGN``;
  per-path validity is enforced from absolute [t_lo, t_hi) bounds.
- both buffers' lengths are multiples of ``ALIGN``.

Words of the 2-bit packing are kept as int64 holding 32-bit patterns:
PyTorch lacks shifts on uint32 on some backends, and int64 keeps every
right shift logical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .extend import DPParams

#: Buffer lengths are padded to multiples of this (the JAX layout's tile).
ALIGN = 1024
_MASK32 = 0xFFFFFFFF


@dataclass
class DeviceData:
    reads2: torch.Tensor  # int8 (2N + pad,)
    panel_padded: torch.Tensor  # int8 (pad + total + pad,)
    panel_start: np.ndarray  # int64 per-path start into panel_padded (host)
    panel_len: np.ndarray  # int64 per-path length (host)
    n_bases: int  # N (forward half length)
    pad: int
    #: 2-bit-packed (words, rn, pw, pn) of reads2 and panel_padded, computed
    #: once at upload (the window prep of every batch reads them).
    packed: Optional[tuple] = None

    def packed_words(self) -> tuple:
        """The (rw, rn, pw, pn) word buffers; raises if not built by upload()."""
        if self.packed is None:
            raise ValueError(
                "DeviceData.packed is unset: construct DeviceData via "
                "device.upload()"
            )
        return self.packed


def _expand_reads_raw(codes: torch.Tensor, n_cap: int, pad: int) -> torch.Tensor:
    """fwd ++ revcomp ++ sentinel layout from raw (unpadded) codes."""
    fwd = torch.zeros(n_cap, dtype=torch.int8, device=codes.device)
    fwd[: codes.shape[0]] = codes
    flipped = torch.flip(fwd, dims=(0,))
    rc = torch.where(flipped < 4, 3 - flipped, flipped)
    sentinel = torch.full((pad,), 4, dtype=torch.int8, device=codes.device)
    return torch.cat([fwd, rc, sentinel])


def _pack_words(codes: torch.Tensor):
    """2-bit-pack a code array (length % 32 == 0) on its device.

    Returns (words, nwords) as int64 holding uint32 patterns: ``words``
    packs 16 bases per word (sentinel bases packed as 0), ``nwords`` packs
    32 sentinel flags per word.
    """
    c = codes.reshape(-1)
    if c.shape[0] % 32:
        raise ValueError(f"code array length {c.shape[0]} is not a multiple of 32")
    base = torch.where(c < 4, c, 0).view(-1, 16)
    words = torch.zeros(base.shape[0], dtype=torch.int64, device=c.device)
    for s in range(16):
        words |= base[:, s].to(torch.int64) << (2 * s)
    flag = (c == 4).view(-1, 32)
    nwords = torch.zeros(flag.shape[0], dtype=torch.int64, device=c.device)
    for s in range(32):
        nwords |= flag[:, s].to(torch.int64) << s
    return words, nwords


def upload(
    reads_codes: np.ndarray,
    panel,
    device: torch.device,
    panel_cache: Optional[dict] = None,
    max_window: int = 30976,
) -> DeviceData:
    """Upload a read chunk + panel to ``device`` (panel cached across chunks)."""
    pad = max_window + 4 * ALIGN
    if panel_cache is not None and "flat" in panel_cache:
        panel_padded = panel_cache["flat"]
        starts = panel_cache["starts"]
        lens = panel_cache["lens"]
        pw, pn = panel_cache["words"]
    else:
        lens = np.array([p.length for p in panel.paths], dtype=np.int64)
        starts = np.zeros(len(lens), dtype=np.int64)
        if len(lens):
            np.cumsum(lens[:-1], out=starts[1:])
        starts += pad
        total = pad + int(lens.sum()) + pad
        total += (-total) % ALIGN
        flat = np.full(total, 4, dtype=np.int8)
        pos = pad
        for p in panel.paths:
            flat[pos : pos + p.length] = p.seq
            pos += p.length
        panel_padded = torch.from_numpy(flat).to(device)
        pw, pn = _pack_words(panel_padded)
        if panel_cache is not None:
            panel_cache["flat"] = panel_padded
            panel_cache["starts"] = starts
            panel_cache["lens"] = lens
            panel_cache["words"] = (pw, pn)

    n = len(reads_codes)
    # Power-of-two forward-half class, as in the JAX layout.
    n_cap = 1 << max(12, (max(n, 1) - 1).bit_length())
    # Sentinel tail sized so the total is ALIGN-aligned (2*n_cap + pad_tot).
    pad_tot = pad + (-(2 * n_cap + pad)) % ALIGN
    codes = torch.from_numpy(np.ascontiguousarray(reads_codes, dtype=np.int8))
    reads2 = _expand_reads_raw(codes.to(device), n_cap=n_cap, pad=pad_tot)
    rw, rn = _pack_words(reads2)
    return DeviceData(
        reads2=reads2,
        panel_padded=panel_padded,
        panel_start=starts,
        panel_len=lens,
        n_bases=n_cap,
        pad=pad,
        packed=(rw, rn, pw, pn),
    )


def device_of(data: DeviceData) -> torch.device:
    """The device an upload lives on."""
    return data.reads2.device


def _realign(wv: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Words starting ``ph`` bits into word j: (w[j] >> ph) | (w[j+1] << 32-ph)."""
    lo = wv[:, :-1] >> ph
    hi = (wv[:, 1:] << (32 - ph)) & _MASK32
    return lo | torch.where(ph == 0, torch.zeros_like(hi), hi)


def _gather_window_T(words, nwords, start: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gather (P,) windows of n_rows bases -> (n_rows, P) int8 transposed.

    ``start`` may be any base offset; phase realignment combines adjacent
    words. Sentinel (N/pad) bases decode to 4 via the nwords bitmask.
    """
    start = start.to(torch.int64)
    P = start.shape[0]
    dev = start.device

    W = n_rows // 16
    cols = torch.arange(W + 1, dtype=torch.int64, device=dev)[None, :]
    widx = ((start >> 4)[:, None] + cols).clamp_(0, words.shape[0] - 1)
    aligned = _realign(words[widx], ((start & 15) * 2)[:, None])
    bases = torch.empty((P, W, 16), dtype=torch.int8, device=dev)
    for s in range(16):
        bases[:, :, s] = ((aligned >> (2 * s)) & 3).to(torch.int8)

    Wn = n_rows // 32
    ncols = torch.arange(Wn + 1, dtype=torch.int64, device=dev)[None, :]
    nidx = ((start >> 5)[:, None] + ncols).clamp_(0, nwords.shape[0] - 1)
    naligned = _realign(nwords[nidx], (start & 31)[:, None])
    nmask = torch.empty((P, Wn, 32), dtype=torch.bool, device=dev)
    for s in range(32):
        nmask[:, :, s] = ((naligned >> s) & 1) == 1
    q = bases.view(P, n_rows).masked_fill_(nmask.view(P, n_rows), 4)
    return q.T


def _prep_v3_windows_packed(rw, rn, pw, pn, meta: torch.Tensor, bucket: int,
                            band: int):
    """Transposed, sentinel-masked window matrices for the v3 kernel.

    ``meta`` is (5, P) int32 with rows q_start, m, t_start, t_lo, t_hi."""
    q_start, m, t_start, t_lo, t_hi = (meta[i] for i in range(5))
    qT = _gather_window_T(rw, rn, q_start, bucket)
    rows = torch.arange(bucket, dtype=torch.int32, device=meta.device)[:, None]
    qT = torch.where(rows < m[None, :], qT, 4).to(torch.int8)
    tT = _gather_window_T(pw, pn, t_start, bucket + band)
    trows = torch.arange(bucket + band, dtype=torch.int32, device=meta.device)
    t_pos = t_start[None, :] + trows[:, None]
    tvalid = (t_pos >= t_lo[None, :]) & (t_pos < t_hi[None, :])
    tT = torch.where(tvalid, tT, 4).to(torch.int8)
    return qT.contiguous(), tT.contiguous()


# ---- flat-metadata dispatch (production path) ----
#
# One int32 buffer per dispatch round holds every batch's block
# ``[n_valid, row bounds, meta(5*Ppad)]`` back to back, uploaded with one
# host-to-device copy; each batch's prep slices its block out on the device.


def _prep_v3_flat(rw, rn, pw, pn, flat: torch.Tensor, off: int, Ppad: int,
                  bucket: int, band: int):
    """Slice one batch block out of the flat buffer and prep its windows."""
    grid = Ppad // 128
    nvb = flat[off : off + 1 + grid]
    meta = flat[off + 1 + grid : off + 1 + grid + 5 * Ppad].view(5, Ppad)
    qT, tT = _prep_v3_windows_packed(rw, rn, pw, pn, meta, bucket, band)
    return qT, tT, nvb


def flat_block_len(Ppad: int) -> int:
    """Length of one flat block: [n_valid] ++ bounds ++ meta."""
    return 1 + Ppad // 128 + 5 * Ppad


# Copied verbatim from svjedi_tpu/align/device.py:flat_meta_block.
def flat_meta_block(
    meta: np.ndarray, n_valid: int, row_bounds: np.ndarray = None
) -> np.ndarray:
    """Host-side block for one batch: [n_valid] ++ row_bounds ++ meta.

    ``row_bounds`` is the per-128-problem-group max window length (the
    kernel's per-step row loop bound); when None every step runs all rows
    (the m row of the meta is used as the bound source: max per group)."""
    Ppad = meta.shape[1]
    grid = Ppad // 128
    if row_bounds is None:
        row_bounds = meta[1].reshape(grid, 128).max(axis=1)
    return np.concatenate(
        [
            np.array([n_valid], np.int32),
            row_bounds.astype(np.int32),
            meta.ravel().astype(np.int32),
        ]
    )


def upload_flat_meta(blocks, device: torch.device) -> torch.Tensor:
    """Concatenate batch blocks and upload them with one copy.

    The total length is padded to a power-of-two class (the JAX layout)."""
    flat = np.concatenate(blocks) if blocks else np.zeros(1, np.int32)
    cap = 1 << max(12, (len(flat) - 1).bit_length())
    if cap != len(flat):
        flat = np.concatenate([flat, np.zeros(cap - len(flat), np.int32)])
    return torch.from_numpy(flat).to(device)


def window_score_v3_fwd_flat(
    data: DeviceData,
    flat: torch.Tensor,
    off: int,
    Ppad: int,
    bucket: int,
    band: int,
    params: DPParams,
) -> torch.Tensor:
    """v3 forward pass reading its meta block from the flat buffer."""
    from ..kernels.band_dp_v3 import band_dp_v3_fwd

    rw, rn, pw, pn = data.packed_words()
    qT, tT, nv = _prep_v3_flat(rw, rn, pw, pn, flat, off, Ppad, bucket, band)
    return band_dp_v3_fwd(qT, tT, bucket, band, params, nv)


def window_score_v3_rev_flat(
    data: DeviceData,
    flat: torch.Tensor,
    off: int,
    Ppad: int,
    bucket: int,
    band: int,
    params: DPParams,
) -> torch.Tensor:
    """v3 reverse pass reading its meta block from the flat buffer."""
    from ..kernels.band_dp_v3 import band_dp_v3_rev

    rw, rn, pw, pn = data.packed_words()
    qT, tT, nv = _prep_v3_flat(rw, rn, pw, pn, flat, off, Ppad, bucket, band)
    return band_dp_v3_rev(qT, tT, bucket, band, params, nv)
