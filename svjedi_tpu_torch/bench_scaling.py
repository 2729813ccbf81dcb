"""Sharding-efficiency measurement of the count step on the reference bundle.

    python -m svjedi_tpu_torch.bench_scaling [--cpu]

The counterpart of the JAX package's ``tools/bench_scaling.py``, run with
this package's own modules. Wall-clock scaling over several cards needs
several cards; this tool measures, on one device, the two quantities that
bound it on the real workload (the bundle in :data:`TEST_DIR`) and prints
the bound they give:

1. **Sharding overhead**: the count step of ``dist/engine.py`` through
   ``make_sharded_count_step_v3`` on a 1 x 1 mesh against the one-device
   ``dp_filter_count_v3`` on the same problems (every candidate of the
   bundle with a window of at most 2,048 rows, cut to a multiple of 1,024):
   the cost of the sharded wrapping itself (the per-shard slicing, the tag
   mask and the sum), as the mean of 8 calls after a warm one, each window
   ending with the counts on the host.
2. **Load balance**: the multi-device mode round-robins read chunks over
   devices (``align_and_count(devices=...)``); the DP cell volume per read
   from the bundle's seeding gives balance = mean / max of the per-device
   volume for 8 devices, at the reads tiled 10 times.

Per-device work is independent and the one cross-device reduction is an
(n_tags, 2) int32 sum, so the projected 8-device efficiency is
min(1, balance / overhead): a projection from one device, not a
measurement on eight.

The engine is ``v3`` on a card (K1, then K1' on the end-clamped windows)
and ``xla`` on the CPU (``band_dp_batch``'s plain version), as in the JAX
tool. Output: one JSON line with the JAX tool's keys; ``platform`` is the
``torch.device`` type. It runs on ``cuda:0`` and refuses to run without a
card unless given ``--cpu``; without the bundle it raises, naming the
missing file.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

TEST_DIR = Path("/root/reference/test-dir")

#: The JSON line's keys, in the JAX tool's order.
KEYS = ("platform", "engine", "n_problems", "t_single_s", "t_sharded_1dev_s",
        "sharding_overhead_x", "load_balance_8dev_chunks",
        "projected_8chip_efficiency")


class Measurement(NamedTuple):
    line: dict  # the JSON line, keys as in KEYS
    single_counts: np.ndarray  # (n_tags, 2) of the one-device step
    sharded_counts: np.ndarray  # (n_tags, 2) of the 1 x 1 sharded step
    k1_launches: int  # forward kernel launches of the measurement
    k1_rev_launches: int  # reverse kernel launches of the measurement


def measure(ref, vcf, reads_path, device: torch.device,
            reps: int = 8) -> Measurement:
    """Both quantities on the bundle (``ref``, ``vcf``, ``reads_path``),
    on ``device``; each step is warmed once and timed over ``reps`` calls."""
    from .align import device as dev
    from .align.extend import DPParams
    from .align.index import build_panel_index
    from .align.pipeline import candidate_layout
    from .align.seed import ChainParams, seed_candidates
    from .config import AlignConfig
    from .dist.count_step import build_owned_table
    from .dist.engine import dp_filter_count_v3, make_sharded_count_step_v3
    from .dist.mesh import make_mesh
    from .graph.build import build_graph
    from .graph.cluster import build_panel
    from .graph.svparse import parse_vcf_svs
    from .io.fasta import read_fasta
    from .io.fastq import read_reads
    from .kernels import band_dp_v3

    engine = "xla" if device.type == "cpu" else "v3"

    cfg = AlignConfig(buckets=(2048,))
    chroms = read_fasta(ref)
    parsed = parse_vcf_svs(vcf, {c: len(s) for c, s in chroms.items()})
    graph = build_graph(chroms, parsed)
    panel = build_panel(
        graph, flank=cfg.flank, cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
    )
    index = build_panel_index(
        panel, k=cfg.kmer, w=cfg.window,
        max_hits_per_minimizer=cfg.max_hits_per_minimizer,
    )
    reads = read_reads(str(reads_path))
    cands = seed_candidates(reads, index, chain_params=ChainParams(
        min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
        max_gap=cfg.chain_max_gap, drift_abs=cfg.chain_drift_abs,
        drift_permille=cfg.chain_drift_permille,
        block_rows=cfg.block_rows,
        ext_min_anchors=cfg.chain_ext_min_anchors,
    ))
    data = dev.upload(reads.codes, panel, device)
    rw_start, m32, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
        reads, index, cands, cfg, data
    )
    sel = np.flatnonzero(keep & (m32 <= 2048))
    P = (len(sel) // 1024) * 1024  # real problems only, 1024-aligned
    sel = sel[:P]
    meta = np.stack(
        [q_start[sel], m32[sel], t_start[sel], t_lo[sel], t_hi[sel]]
    ).astype(np.int32)
    path_start = data.panel_start[cands.path[sel]].astype(np.int32)
    cluster = index.path_cluster[cands.path[sel]].astype(np.int64)
    n_clusters = int(index.path_cluster.max()) + 1
    # Densify (read, cluster) keys before narrowing: the int64 product
    # overflows int32 at production scale (millions of reads x thousands of
    # clusters) and wrapped ids would collide distinct winner groups.
    gkey = cands.read[sel].astype(np.int64) * n_clusters + cluster
    group = np.unique(gkey, return_inverse=True)[1].astype(np.int32)
    cand_path = cands.path[sel].astype(np.int32)
    tags = sorted({t for p in panel.paths for t, *_ in p.owned})
    owned = build_owned_table(panel, {t_: i for i, t_ in enumerate(tags)},
                              device=device)
    n_groups = int(group.max()) + 1

    args = (*data.packed_words(),
            *(torch.from_numpy(x).to(device)
              for x in (meta, path_start, group, cand_path)),
            owned)
    kw = dict(bucket=2048, band=cfg.band, params=DPParams(),
              n_groups=n_groups, n_tags=max(1, len(tags)))

    def timeit(fn):
        # Each window ends with the counts on the host: a CUDA launch
        # returns before the card has done its work.
        fn().cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        out = out.cpu()
        return (time.perf_counter() - t0) / reps, out.numpy()

    launches0 = band_dp_v3.launches
    rev0 = band_dp_v3.rev_launches
    t_single, single_counts = timeit(
        lambda: dp_filter_count_v3(*args, engine=engine, **kw)["counts"]
    )
    mesh1 = make_mesh(data_shards=1, graph_shards=1, devices=[device])
    step1 = make_sharded_count_step_v3(
        mesh1, engine=engine, bucket=2048, band=cfg.band,
        params=kw["params"], n_groups_per_shard=n_groups,
        n_tags=kw["n_tags"],
    )
    t_sharded, sharded_counts = timeit(lambda: step1(*args))
    rev = band_dp_v3.rev_launches - rev0
    fwd = band_dp_v3.launches - launches0 - rev
    overhead = t_sharded / t_single

    # Load balance: per-device DP volume of the chunk round-robin at the
    # reads tiled 10 times (run_pipeline shrinks chunk_reads so that every
    # device gets work). Volumes repeat per replica, so one replica's
    # per-read volume is computed and tiled.
    n_dev = 8
    reps10 = 10
    n_reads10 = reads.n_reads * reps10
    chunk = max(512, -(-n_reads10 // n_dev))
    cell1 = np.zeros(reads.n_reads)
    np.add.at(
        cell1, cands.read[keep],
        m32[keep].astype(np.float64) * cfg.band,
    )
    cell10 = np.tile(cell1, reps10)
    vol = np.array([
        cell10[di * chunk : (di + 1) * chunk].sum() for di in range(n_dev)
    ])
    balance = float(vol.mean() / max(1.0, vol.max()))

    line = {
        "platform": device.type,
        "engine": engine,
        "n_problems": int(P),
        "t_single_s": round(t_single, 4),
        "t_sharded_1dev_s": round(t_sharded, 4),
        "sharding_overhead_x": round(overhead, 3),
        "load_balance_8dev_chunks": round(balance, 3),
        "projected_8chip_efficiency": round(
            min(1.0, balance / max(overhead, 1e-9)), 3
        ),
    }
    return Measurement(line, single_counts, sharded_counts, fwd, rev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m svjedi_tpu_torch.bench_scaling",
        description="Sharding overhead and load balance of the count step "
                    f"on the bundle in {TEST_DIR}.")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: cuda:0, refused without "
                         "a card)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        from .pipeline import select_device

        try:
            device = select_device()
        except RuntimeError:
            ap.error("no CUDA device is visible; --cpu runs on the CPU")
    result = measure(TEST_DIR / "reference_genome.fasta",
                     TEST_DIR / "test.vcf",
                     TEST_DIR / "simulated_reads.fastq.gz", device)
    print(json.dumps(result.line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
