"""Sharded count step on the production two-pass engine (K1 and K1′).

Counterpart of ``svjedi_tpu/dist/engine.py``. One step takes the production
device layout (the 2-bit packed read/panel word buffers and the (5, P)
window metadata of ``align/device.py``), runs the v3 band DP for both passes
(forward for (score, qe, te), reverse on the end-clamped windows for (qs,
ts)), applies the winner, junction-coverage and density rules, and counts
per (tag, allele).

Sharding layout, as in the JAX package:

- candidate problems split equally over ``data`` (each data shard DPs its
  slice on its device);
- packed sequence buffers and the owned-link table are replicated;
- the tag (SV) space is range-partitioned over ``graph``;
- the masked (n_tags, 2) count matrices are summed on ``devices[0, 0]``,
  the one reduction (the JAX package's ``psum``).

The JAX segment reductions (``jax.ops.segment_max/min/sum``) are
``scatter_reduce`` (``amax``/``amin``/``sum``) over a fill of the dtype's
identity, which is what JAX leaves in an empty segment.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..align.device import DeviceData, _prep_v3_windows_packed
from ..align.extend import DPParams, band_dp_batch
from .count_step import OwnedTable
from .mesh import Mesh

ENGINES = ("v3", "v3i", "xla")


def segment_reduce(reduce: str, vals: torch.Tensor, seg: torch.Tensor,
                   n_seg: int) -> torch.Tensor:
    """``jax.ops.segment_{max,min,sum}``: ``reduce`` is ``amax``, ``amin`` or
    ``sum``; an empty segment holds the dtype's identity."""
    info = torch.iinfo(vals.dtype)
    fill = {"amax": info.min, "amin": info.max, "sum": 0}[reduce]
    out = torch.full((n_seg,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), vals, reduce,
                               include_self=True)


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``device``."""
    return torch.as_tensor(x).to(device)


def dp_filter_count_v3(
    rw: torch.Tensor,  # packed read words (device.upload layout)
    rn: torch.Tensor,
    pw: torch.Tensor,  # packed panel words
    pn: torch.Tensor,
    meta,  # (5, P) int32 rows per device.META_ROWS
    path_start,  # (P,) int32 panel_start[cand_path]
    group,  # (P,) int32 winner-competition group id
    cand_path,  # (P,) int32 panel path id
    owned: OwnedTable,
    *,
    bucket: int,
    band: int,
    params: DPParams,
    n_groups: int,
    n_tags: int,
    d_over: int = 100,
    min_score: int = 40,
    min_density_millis: int = 500,
    engine: str = "v3",
    tag_lo: int = 0,
    tag_hi: int = 1 << 30,
) -> Dict[str, torch.Tensor]:
    """Production-engine DP → winner → junction counts, on ``rw``'s device.

    ``engine``: ``v3`` is the two-pass ``band_dp_v3`` (K1, then K1′ on the
    end-clamped windows, on CUDA tensors; their plain versions on CPU
    tensors), ``v3i`` the same wrapper on the plain forward pass on either
    device, ``xla`` the one-pass ``band_dp_batch`` (the kernel G1 on CUDA
    tensors, its plain version on CPU tensors). The reverse pass runs
    for every candidate. ``meta``, ``path_start``, ``group`` and
    ``cand_path`` may be arrays; they are moved to the device.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    dev = rw.device
    i32 = torch.int32
    meta, path_start, group, cand_path = (
        _on(x, dev).to(i32) for x in (meta, path_start, group, cand_path))
    owned = owned.to(dev)
    qT, tT = _prep_v3_windows_packed(rw, rn, pw, pn, meta, bucket, band)
    if engine in ("v3", "v3i"):
        from ..kernels import band_dp_v3 as v3

        fwd = v3.band_dp_v3_fwd if engine == "v3" else v3.band_dp_v3_fwd_ref
        out = v3.band_dp_v3(qT, tT, bucket, band, params, fwd=fwd)
    else:
        # The one-pass DP takes (P, rows) windows: a copy of the transposes.
        out = band_dp_batch(qT.T.contiguous(), tT.T.contiguous(), band, params)
    score = out["score"].to(i32)
    qs, qe = out["qs"].to(i32), out["qe"].to(i32)
    # Window coords → path coords (meta row 2 is absolute into the padded
    # panel buffer; lane 0 of the target window sits at that offset).
    toff = meta[2] - path_start
    ts = out["ts"].to(i32) + toff
    te = out["te"].to(i32) + toff

    # Winner per group under the production count rules: score floor and
    # score-density floor (align/pipeline.py prune_secondaries).
    span = torch.maximum(qe - qs + 1, te - ts + 1)
    dense = score * 1000 >= min_density_millis * span
    qual = (score >= min_score) & dense
    eff = torch.where(qual, score, -1)
    best = segment_reduce("amax", eff, group, n_groups)
    n = meta.shape[1]
    idx = torch.arange(n, dtype=i32, device=dev)
    big = 1 << 30
    tied = (eff == best[group.long()]) & qual
    first = segment_reduce("amin", torch.where(tied, idx, big), group, n_groups)
    is_winner = tied & (idx == first[group.long()])

    # Junction coverage for every owned link of the winner's path
    # (filter-alignments.py:258-273 in path coordinates), masked to the
    # tag range [tag_lo, tag_hi).
    cp = cand_path.long()
    oj = owned.junction[cp]
    otag = owned.tag[cp]
    oall = owned.allele[cp]
    ovalid = owned.valid[cp]
    covers = (
        ovalid
        & is_winner[:, None]
        & ((oj - ts[:, None]) >= d_over)
        & ((te[:, None] - oj + 1) >= d_over)
        & (otag >= tag_lo)
        & (otag < tag_hi)
    )
    flat = (otag * 2 + oall).reshape(-1)
    contrib = covers.to(i32).reshape(-1)
    counts = segment_reduce("sum", contrib, flat, 2 * n_tags)
    return {
        "counts": counts.reshape(n_tags, 2),
        "score": score,
        "qs": qs,
        "ts": ts,
        "qe": qe,
        "te": te,
        "is_winner": is_winner,
    }


def make_sharded_count_step_v3(
    mesh: Mesh,
    *,
    bucket: int,
    band: int,
    params: DPParams,
    n_groups_per_shard: int,
    n_tags: int,
    d_over: int = 100,
    min_score: int = 40,
    min_density_millis: int = 500,
    engine: str = "v3",
):
    """The count step over a (data, graph) mesh.

    The columns of ``meta``, ``path_start``, ``group`` and ``cand_path``
    split equally over ``data``; the packed buffers and the owned table are
    replicated. Data shard d runs the DP once on ``devices[d, 0]``; graph
    shard (d, g) keeps, on ``devices[d, g]``, the tag range
    ``[g * ceil(n_tags / G), ...)`` of its counts, and the masked matrices
    are summed on ``devices[0, 0]``: the exact global (n_tags, 2) int32
    matrix. Group ids are shard-local (callers give each data shard its own
    candidate groups, :func:`assert_no_group_straddle`).
    """
    n_data, n_graph = mesh.devices.shape
    tags_per_shard = -(-n_tags // n_graph)
    root = mesh.devices[0, 0]

    def step(rw, rn, pw, pn, meta, path_start, group, cand_path, owned):
        cols = (torch.as_tensor(meta), torch.as_tensor(path_start),
                torch.as_tensor(group), torch.as_tensor(cand_path))
        P = cols[0].shape[1]
        if P % n_data:
            raise ValueError(f"{P} problems do not split over {n_data} data "
                             f"shards")
        width = P // n_data
        total = torch.zeros((n_tags, 2), dtype=torch.int32, device=root)
        for d in range(n_data):
            dev = mesh.devices[d, 0]
            shard = (c[..., d * width:(d + 1) * width] for c in cols)
            out = dp_filter_count_v3(
                rw.to(dev), rn.to(dev), pw.to(dev), pn.to(dev), *shard,
                owned,
                bucket=bucket, band=band, params=params,
                n_groups=n_groups_per_shard, n_tags=n_tags, d_over=d_over,
                min_score=min_score, min_density_millis=min_density_millis,
                engine=engine,
            )
            for g in range(n_graph):
                gdev = mesh.devices[d, g]
                lo = g * tags_per_shard
                hi = min(lo + tags_per_shard, n_tags)
                ids = torch.arange(n_tags, device=gdev)
                counts = out["counts"].to(gdev)
                mine = torch.where(((ids >= lo) & (ids < hi))[:, None],
                                   counts, 0)
                total += mine.to(root)
        return total

    return step


# Copied verbatim from svjedi_tpu/dist/engine.py:packed_buffers.
def packed_buffers(data: DeviceData):
    """The (rw, rn, pw, pn) word buffers of a production upload."""
    return data.packed_words()


# Copied verbatim from svjedi_tpu/dist/engine.py:assert_no_group_straddle.
def assert_no_group_straddle(
    group: np.ndarray, meta: np.ndarray, data_shards: int
) -> None:
    """Check that no winner-competition group straddles a data-shard cut.

    ``make_sharded_count_step_v3`` elects one winner PER SHARD per group id;
    a (read, cluster) group split across the equal data split would be
    counted once per shard it touches. Padding rows (meta window length 0)
    are ignored — they can never win. Raises AssertionError on a straddle.
    """
    P = len(group)
    if data_shards <= 1 or P == 0:
        return
    assert P % data_shards == 0, (P, data_shards)
    shard_len = P // data_shards
    m = np.asarray(meta)[1]
    real = m > 0
    g = np.asarray(group)
    for b in range(shard_len, P, shard_len):
        left = g[:b][real[:b]]
        right = g[b:][real[b:]]
        common = np.intersect1d(left, right)
        assert common.size == 0, (
            f"groups {common[:8].tolist()} straddle the shard cut at {b}"
        )
