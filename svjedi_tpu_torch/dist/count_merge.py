"""Count merge on a (data, graph) mesh: winners → per-(SV, allele) counts.

Counterpart of ``svjedi_tpu/dist/count_merge.py``, the counting engine of
``run --graph-shards``. It reproduces the host count
(``svjedi_tpu/align/pipeline.py:count_support``, in the port
``align/pipeline.py:count_support_flat``) exactly (junction coverage in path
coordinates, allele exclusivity per (read, SV), and per-(read, link, tag,
allele) dedup) as segment reductions over a flattened winner x owned-link
table. The host computes the integer segment labels (the numpy part below,
copied verbatim); each (data, graph) shard does every per-entry test and
reduction on its device, and the shards' matrices are summed on
``devices[0, 0]``, as the JAX package's ``psum`` does. Reads never straddle
a data shard, so shard-local segment ids are exact.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .engine import segment_reduce
from .mesh import Mesh

# Copied verbatim from svjedi_tpu/dist/count_merge.py: _BIG through _segment_np.
_BIG = np.int32(1 << 30)


class EntryTable(NamedTuple):
    """Flattened winner×owned entries, laid out per data shard.

    Every array has shape (n_shards * E,) with shard s owning the slice
    [s*E, (s+1)*E); padding entries have valid=False. Entry ids and winner
    row ids are SHARD-LOCAL; insertion order (winner row asc, owned column
    asc — the host dict's iteration order) is preserved inside each shard.
    """

    j: np.ndarray  # int32 junction offsets (path space)
    tag: np.ndarray  # int32 tag id
    allele: np.ndarray  # int32 0/1
    ts: np.ndarray  # int32 winner target start
    te: np.ndarray  # int32 winner target end
    score: np.ndarray  # int32 winner score
    row: np.ndarray  # int32 shard-local winner row id
    g_rt: np.ndarray  # int32 shard-local dense (read, tag) segment id
    g_dd: np.ndarray  # int32 shard-local dense (read, tag, link, allele) id
    valid: np.ndarray  # bool
    n_rt: int  # segments per shard (max over shards, pow2-padded)
    n_dd: int
    shard_width: int  # E


def _dense(keys: np.ndarray) -> np.ndarray:
    return np.unique(keys, return_inverse=True)[1]


def build_entry_table(
    panel,
    winners,
    tag_to_id: Dict[str, int],
    n_shards: int = 1,
    min_density: float = 0.0,
) -> Optional[EntryTable]:
    """Flatten winners×owned and label segments, sharded by read.

    Winner rows are read-sorted (finalize_chunk emits per-chunk winners in
    (read, cluster) order and chunks cover disjoint read ranges), so
    contiguous read blocks are dealt round-robin to shards; all entries of
    one read land on one shard and shard-local insertion order equals the
    global order restricted to that shard.
    """
    n_w = len(winners.read)
    if n_w == 0:
        return None
    if min_density > 0:
        # Density gate, byte-equal to the host count_support rule.
        span = np.maximum(1, winners.te - winners.ts + 1)
        ok = winners.score >= min_density * span
        if not ok.all():
            import types

            winners = types.SimpleNamespace(
                **{
                    f: getattr(winners, f)[ok]
                    for f in ("read", "path", "ts", "te", "score")
                }
            )
            n_w = len(winners.read)
            if n_w == 0:
                return None
    K = max([len(p.owned) for p in panel.paths] + [1])
    n_paths = len(panel.paths)
    J = np.zeros((n_paths, K), np.int32)
    T = np.zeros((n_paths, K), np.int32)
    A = np.zeros((n_paths, K), np.int32)
    L = np.zeros((n_paths, K), np.int32)
    V = np.zeros((n_paths, K), bool)
    for pid, path in enumerate(panel.paths):
        for col, (t, a, j, li) in enumerate(path.owned):
            J[pid, col] = j
            T[pid, col] = tag_to_id[t]
            A[pid, col] = a
            L[pid, col] = li
            V[pid, col] = True

    path = winners.path.astype(np.int64)
    read = winners.read.astype(np.int64)
    # Deal reads round-robin to shards (whole reads only).
    uniq_reads, read_dense = np.unique(read, return_inverse=True)
    shard_of_row = (read_dense % n_shards).astype(np.int64)

    e_j = J[path]  # (n_w, K)
    e_tag = T[path]
    e_allele = A[path]
    e_link = L[path]
    e_valid = V[path]
    e_ts = np.broadcast_to(
        winners.ts.astype(np.int64)[:, None], (n_w, K)
    )
    e_te = np.broadcast_to(
        winners.te.astype(np.int64)[:, None], (n_w, K)
    )
    e_score = np.broadcast_to(
        winners.score.astype(np.int64)[:, None], (n_w, K)
    )

    n_tags = max(tag_to_id.values(), default=0) + 1
    # Per-entry 64-bit keys (host side only; the device sees dense ids).
    rd = np.broadcast_to(read[:, None], (n_w, K)).astype(np.int64)
    key_rt = rd * n_tags + e_tag
    key_dd = (key_rt * (int(e_link.max()) + 1) + e_link) * 2 + e_allele

    shards: List[Dict[str, np.ndarray]] = []
    max_E = 1
    max_rt = 1
    max_dd = 1
    for s in range(n_shards):
        rows = np.flatnonzero(shard_of_row == s)
        fl = lambda a: a[rows].reshape(-1)  # noqa: E731 (row-major: row asc, col asc)
        v = fl(e_valid)
        krt, kdd = fl(key_rt), fl(key_dd)
        # Dense ids over VALID entries; padding gets the dump segment.
        if v.any():
            g_rt = np.full(len(v), 0, np.int64)
            g_rt[v] = _dense(krt[v])
            n_rt = int(g_rt[v].max()) + 1
            g_dd = np.full(len(v), 0, np.int64)
            g_dd[v] = _dense(kdd[v])
            n_dd = int(g_dd[v].max()) + 1
            g_rt[~v] = n_rt
            g_dd[~v] = n_dd
        else:
            g_rt = np.zeros(len(v), np.int64)
            g_dd = np.zeros(len(v), np.int64)
            n_rt = n_dd = 1
        local_row = np.repeat(np.arange(len(rows), dtype=np.int64), K)
        shards.append({
            "j": fl(e_j), "tag": fl(e_tag), "allele": fl(e_allele),
            "ts": fl(e_ts), "te": fl(e_te), "score": fl(e_score),
            "row": local_row, "g_rt": g_rt, "g_dd": g_dd, "valid": v,
        })
        max_E = max(max_E, len(v))
        max_rt = max(max_rt, n_rt)
        max_dd = max(max_dd, n_dd)

    def pow2(x: int) -> int:
        p = 1
        while p < x:
            p <<= 1
        return p

    E = pow2(max_E)
    n_rt = max_rt
    n_dd = max_dd

    def pad(a: np.ndarray, fill, dtype) -> np.ndarray:
        out = np.full(E, fill, dtype=dtype)
        out[: len(a)] = a
        return out

    cols = {k: [] for k in shards[0]}
    for sh in shards:
        cols["j"].append(pad(sh["j"], 0, np.int32))
        cols["tag"].append(pad(sh["tag"], 0, np.int32))
        cols["allele"].append(pad(sh["allele"], 0, np.int32))
        cols["ts"].append(pad(sh["ts"], 0, np.int32))
        cols["te"].append(pad(sh["te"], 0, np.int32))
        cols["score"].append(pad(sh["score"], 0, np.int32))
        cols["row"].append(pad(sh["row"], 0, np.int32))
        cols["g_rt"].append(pad(sh["g_rt"], n_rt, np.int32))
        cols["g_dd"].append(pad(sh["g_dd"], n_dd, np.int32))
        cols["valid"].append(pad(sh["valid"], False, bool))
    return EntryTable(
        j=np.concatenate(cols["j"]),
        tag=np.concatenate(cols["tag"]),
        allele=np.concatenate(cols["allele"]),
        ts=np.concatenate(cols["ts"]),
        te=np.concatenate(cols["te"]),
        score=np.concatenate(cols["score"]),
        row=np.concatenate(cols["row"]),
        g_rt=np.concatenate(cols["g_rt"]),
        g_dd=np.concatenate(cols["g_dd"]),
        valid=np.concatenate(cols["valid"]),
        n_rt=n_rt,
        n_dd=n_dd,
        shard_width=E,
    )


def count_entries_np(et: EntryTable, n_tags: int, d_over: int) -> np.ndarray:
    """Numpy semantics reference of the device step (tests cross-check).

    Operates shard by shard with shard-local segments, like the device.
    """
    total = np.zeros((n_tags, 2), np.int64)
    n_shards = len(et.j) // et.shard_width
    for s in range(n_shards):
        sl = slice(s * et.shard_width, (s + 1) * et.shard_width)
        total += _count_one_shard_np(
            {f: getattr(et, f)[sl] for f in (
                "j", "tag", "allele", "ts", "te", "score", "row",
                "g_rt", "g_dd", "valid",
            )},
            et.n_rt, et.n_dd, n_tags, d_over,
        )
    return total


def _count_one_shard_np(e, n_rt, n_dd, n_tags, d_over) -> np.ndarray:
    covers = (
        e["valid"]
        & ((e["j"] - e["ts"]) >= d_over)
        & ((e["te"] - e["j"] + 1) >= d_over)
    )
    E = len(covers)
    idx = np.arange(E, dtype=np.int64)
    seg = lambda op, vals, fill: _segment_np(  # noqa: E731
        op, vals, e["g_rt"], n_rt + 1, fill
    )
    a_min = seg(np.minimum, np.where(covers, e["allele"], 2), 2)
    a_max = seg(np.maximum, np.where(covers, e["allele"], -1), -1)
    multi = (a_min == 0) & (a_max == 1)
    best = seg(np.maximum, np.where(covers, e["score"], -1), -1)
    best_i = seg(
        np.minimum,
        np.where(covers & (e["score"] == best[e["g_rt"]]), e["row"], _BIG),
        _BIG,
    )
    first_e = seg(
        np.minimum,
        np.where(covers & (e["row"] == best_i[e["g_rt"]]), idx, _BIG),
        _BIG,
    )
    keep_allele = e["allele"][np.minimum(first_e, E - 1)]
    sel = covers & (
        ~multi[e["g_rt"]] | (e["allele"] == keep_allele[e["g_rt"]])
    )
    first_d = _segment_np(
        np.minimum, np.where(sel, idx, _BIG), e["g_dd"], n_dd + 1, _BIG
    )
    counted = sel & (idx == first_d[e["g_dd"]])
    flat = e["tag"] * 2 + e["allele"]
    out = np.zeros(2 * n_tags, np.int64)
    np.add.at(out, flat[counted], 1)
    return out.reshape(n_tags, 2)


def _segment_np(op, vals, seg_ids, n_seg, fill):
    out = np.full(n_seg, fill, dtype=np.asarray(vals).dtype)
    getattr(op, "at")(out, seg_ids, vals)
    return out


#: The entry columns, in the order the count step takes them.
ENTRY_FIELDS = ("j", "tag", "allele", "ts", "te", "score", "row", "g_rt",
                "g_dd", "valid")


def _count_one_shard(e: Dict[str, torch.Tensor], n_rt: int, n_dd: int,
                     n_tags: int, d_over: int, lo: int,
                     hi: int) -> torch.Tensor:
    """One shard's (n_tags, 2) int32 counts, tags in [lo, hi) only; the
    torch form of ``_count_one_shard_np`` (``make_mesh_count_step``'s body
    in the JAX package)."""
    j, tag, allele, ts, te = e["j"], e["tag"], e["allele"], e["ts"], e["te"]
    score, row, valid = e["score"], e["row"], e["valid"]
    g_rt, g_dd = e["g_rt"].long(), e["g_dd"].long()
    covers = valid & ((j - ts) >= d_over) & ((te - j + 1) >= d_over)
    E = j.shape[0]
    idx = torch.arange(E, dtype=torch.int32, device=j.device)
    big = 1 << 30
    a_min = segment_reduce("amin", torch.where(covers, allele, 2), g_rt,
                           n_rt + 1)
    a_max = segment_reduce("amax", torch.where(covers, allele, -1), g_rt,
                           n_rt + 1)
    multi = (a_min == 0) & (a_max == 1)
    best = segment_reduce("amax", torch.where(covers, score, -1), g_rt,
                          n_rt + 1)
    best_i = segment_reduce(
        "amin", torch.where(covers & (score == best[g_rt]), row, big), g_rt,
        n_rt + 1)
    first_e = segment_reduce(
        "amin", torch.where(covers & (row == best_i[g_rt]), idx, big), g_rt,
        n_rt + 1)
    keep_allele = allele[first_e.clamp(max=E - 1).long()]
    sel = covers & (~multi[g_rt] | (allele == keep_allele[g_rt]))
    first_d = segment_reduce("amin", torch.where(sel, idx, big), g_dd,
                             n_dd + 1)
    counted = sel & (idx == first_d[g_dd])
    counted &= (tag >= lo) & (tag < hi)
    flat = tag * 2 + allele
    counts = segment_reduce("sum", counted.to(torch.int32), flat, 2 * n_tags)
    return counts.reshape(n_tags, 2)


def make_mesh_count_step(
    mesh: Mesh,
    *,
    n_rt: int,
    n_dd: int,
    n_tags: int,
    d_over: int,
):
    """The count step over an :class:`EntryTable`'s columns on a (data,
    graph) mesh.

    Entries split equally over ``data``; graph shard (d, g) counts, on
    ``devices[d, g]``, data shard d's entries in its disjoint tag range;
    the matrices are summed on ``devices[0, 0]``: the exact global (n_tags,
    2) int32 matrix. Byte-equal to the host count (tested).
    """
    n_data, n_graph = mesh.devices.shape
    tags_per = -(-n_tags // n_graph)
    root = mesh.devices[0, 0]

    def step(*columns):
        cols = [torch.as_tensor(c) for c in columns]
        width = cols[0].shape[0] // n_data
        total = torch.zeros((n_tags, 2), dtype=torch.int32, device=root)
        for d in range(n_data):
            for g in range(n_graph):
                dev = mesh.devices[d, g]
                e = {f: c[d * width:(d + 1) * width].to(dev)
                     for f, c in zip(ENTRY_FIELDS, cols)}
                lo = g * tags_per
                total += _count_one_shard(e, n_rt, n_dd, n_tags, d_over, lo,
                                          lo + tags_per).to(root)
        return total

    return step


def mesh_count_support(
    panel,
    winners,
    mesh: Mesh,
    d_over: int = 100,
    tags: Optional[Sequence[str]] = None,
    min_density: float = 0.0,
) -> Dict[str, List[int]]:
    """Counts dict from merged winners via the mesh count step.

    Drop-in replacement for the host count, ``count_support_flat`` (audit
    lines excluded; those stay host-side); tags absent from every winner
    are omitted, matching the host dict's setdefault behavior.
    """
    if tags is None:
        tags = sorted({t for p in panel.paths for t, *_ in p.owned})
    tag_to_id = {t: i for i, t in enumerate(tags)}
    n_tags = max(1, len(tags))
    n_data = mesh.shape["data"]
    et = build_entry_table(
        panel, winners, tag_to_id, n_shards=n_data,
        min_density=min_density,
    )
    if et is None:
        return {}
    step = make_mesh_count_step(
        mesh, n_rt=et.n_rt, n_dd=et.n_dd, n_tags=n_tags, d_over=d_over
    )
    mat = step(*(getattr(et, f) for f in ENTRY_FIELDS)).cpu().numpy()
    out: Dict[str, List[int]] = {}
    for ti, t in enumerate(tags):
        ref, alt = int(mat[ti, 0]), int(mat[ti, 1])
        if ref or alt:
            out[t] = [ref, alt]
    return out
