"""Entry points: the one-device count step and the multi-device dry run.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns the production count step (packed-word window prep
  → band DP forward and reverse → winner → junction counts, as in
  ``dist/engine.py``) on a problem built by the production seeding stages,
  with its example arguments.
- :func:`dryrun_multichip` builds an n-device (data x graph) mesh and checks
  the distribution layer on it:
  1. the sharded count step (candidate problems split over ``data``, the SV
     tag space range-partitioned over ``graph``, one sum) reproduces the
     one-device counts exactly;
  2. ``align_and_count`` with its chunks round-robin over the devices
     reproduces the one-device counts exactly;
  3. the genomic-range decoy shards reproduce the unsharded suppression,
     and the per-shard claimed-chain counts, summed over the graph axis,
     give the unsharded chain count.

A device list may repeat a device, so all of it runs on one card or on the
CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .pipeline import select_device


def production_problem(
    pad_to: int = 128,
    data_shards: int = 1,
    device: Optional[torch.device] = None,
    reads=None,
    genome: Optional[Tuple[dict, str]] = None,
    bucket: int = 512,
):
    """A real problem set, built by the production stages.

    Genome → variation graph → panel (+ minimizer index) → seeded, chained
    candidates → device upload (on ``device``, default the card) + window
    layout; the candidates with a window of at most ``bucket`` rows are
    kept. By default the genome and the reads are
    ``__graft_entry__._production_problem``'s (a simulated 30 kb genome
    with 4 SVs, 3x of ~380-base reads, seeds 3 and 0): short reads keep
    every chain a single block, so the per-group winner rule coincides
    with the host chain reduction. ``genome`` = (chromosomes, SV VCF path)
    and ``reads`` (a ``ReadSet``) replace them.

    ``data_shards`` > 1 lays the problems out for
    ``make_sharded_count_step_v3``'s equal data split: groups are assigned
    round-robin to shards, each shard's rows are packed contiguously into
    its slice and padded to a common width (a multiple of ``pad_to``), so
    no (read, cluster) group straddles a shard boundary.
    """
    from .align import device as dev
    from .align.extend import DPParams
    from .align.index import build_panel_index
    from .align.pipeline import candidate_layout
    from .align.seed import ChainParams, seed_candidates
    from .config import AlignConfig
    from .dist.count_step import build_owned_table
    from .graph.build import build_graph
    from .graph.cluster import build_panel
    from .graph.svparse import parse_vcf_svs
    from .io import sim
    from .io.fastq import ReadSet, encode_ascii

    device = device or select_device()
    cfg = AlignConfig(buckets=(bucket,))
    if genome is None:
        simulation = sim.simulate(
            seed=3, chrom_lengths={"c1": 30_000}, n_svs=4,
            sv_types=("DEL", "INS", "INV"),
        )
        chroms = simulation.chroms
        with tempfile.TemporaryDirectory() as tmp:
            vcf = os.path.join(tmp, "t.vcf")
            sim.write_truth_vcf(simulation, vcf)
            parsed = parse_vcf_svs(
                vcf, {c: len(s) for c, s in chroms.items()}
            )
    else:
        chroms, vcf = genome
        parsed = parse_vcf_svs(vcf, {c: len(s) for c, s in chroms.items()})
    graph = build_graph(chroms, parsed)
    panel = build_panel(graph, flank=cfg.flank, cluster_gap=cfg.cluster_gap)
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window)

    if reads is None:
        rng = np.random.default_rng(0)
        names, seqs = sim.simulate_reads(
            rng, simulation.haplotypes, coverage=3.0,
            mean_len=380, sd_len=40, min_len=300,
            sub_rate=0.02, ins_rate=0.01, del_rate=0.01,
        )
        codes = np.concatenate([encode_ascii(s) for s in seqs])
        offsets = np.concatenate(
            [[0], np.cumsum([len(s) for s in seqs])]
        ).astype(np.int64)
        reads = ReadSet(names=names, codes=codes, offsets=offsets)

    cands = seed_candidates(reads, index, chain_params=ChainParams())
    data = dev.upload(reads.codes, panel, device, max_window=bucket)
    rw_start, m32, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
        reads, index, cands, cfg, data
    )
    sel = np.flatnonzero(keep & (m32 <= bucket))
    n = len(sel)

    # Dense global group ids (valid as segment ids on every shard as long
    # as each group's rows live on ONE shard).
    cluster = index.path_cluster[cands.path[sel]].astype(np.int64)
    n_clusters = int(index.path_cluster.max()) + 1
    gkey = cands.read[sel].astype(np.int64) * n_clusters + cluster
    order = np.argsort(gkey, kind="stable")  # group rows contiguous
    sel, gkey = sel[order], gkey[order]
    uniq, dense = np.unique(gkey, return_inverse=True)

    # Round-robin groups over shards; pack each shard's rows contiguously.
    bounds = np.searchsorted(dense, np.arange(len(uniq) + 1))
    shard_rows = [[] for _ in range(data_shards)]
    for gi in range(len(uniq)):
        shard_rows[gi % data_shards].append(
            np.arange(bounds[gi], bounds[gi + 1])
        )
    per_shard = [
        np.concatenate(r) if r else np.zeros(0, np.int64)
        for r in shard_rows
    ]
    widest = max([len(p) for p in per_shard] + [1])
    Pshard = -(-widest // pad_to) * pad_to
    P = Pshard * data_shards

    meta = np.zeros((5, P), dtype=np.int32)
    path_start = np.zeros(P, dtype=np.int32)
    cand_path = np.zeros(P, dtype=np.int32)
    group = np.zeros(P, dtype=np.int32)
    for s, rows in enumerate(per_shard):
        dst = slice(s * Pshard, s * Pshard + len(rows))
        src = sel[rows]
        meta[0, dst] = q_start[src]
        meta[1, dst] = m32[src]  # padding rows keep m=0 (empty problems)
        meta[2, dst] = t_start[src]
        meta[3, dst] = t_lo[src]
        meta[4, dst] = t_hi[src]
        path_start[dst] = data.panel_start[cands.path[src]].astype(np.int32)
        cand_path[dst] = cands.path[src]
        group[dst] = dense[rows]

    tags = sorted({t for p in panel.paths for t, *_ in p.owned})
    tag_to_id = {t_: i for i, t_ in enumerate(tags)}
    owned = build_owned_table(panel, tag_to_id, device=device)
    return {
        "reads": reads, "panel": panel, "index": index, "cfg": cfg,
        "data": data, "meta": meta, "path_start": path_start,
        "group": group, "cand_path": cand_path, "owned": owned,
        "n_groups": len(uniq) if len(uniq) else 1,
        "n_tags": max(1, len(tags)),
        "tags": tags, "params": DPParams(), "bucket": bucket,
        "band": cfg.band, "n_real": n,
        "real_per_shard": [len(p) for p in per_shard],
    }


def entry(device: Optional[torch.device] = None):
    """(fn, example_args): the count step on ``device`` (default the card;
    ``v3``, the kernels, on a card, the one-pass ``xla`` engine on the CPU)
    and the arguments of one call."""
    from .dist.engine import dp_filter_count_v3

    device = device or select_device()
    prob = production_problem(device=device)
    engine = "xla" if device.type == "cpu" else "v3"
    rw, rn, pw, pn = prob["data"].packed_words()

    def step(rw, rn, pw, pn, meta, path_start, group, cand_path, owned):
        return dp_filter_count_v3(
            rw, rn, pw, pn, meta, path_start, group, cand_path, owned,
            bucket=prob["bucket"], band=prob["band"], params=prob["params"],
            n_groups=prob["n_groups"], n_tags=prob["n_tags"], engine=engine,
        )["counts"]

    example_args = (
        rw, rn, pw, pn, prob["meta"], prob["path_start"], prob["group"],
        prob["cand_path"], prob["owned"],
    )
    return step, example_args


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(
    n_devices: int, devices: Optional[Sequence[torch.device]] = None
) -> None:
    """Run the distribution layer's paths on an n-device mesh over the first
    ``n_devices`` of ``devices`` (default: every visible card) and check
    each against its one-device result; raises AssertionError on a
    difference."""
    from .align.decoy import build_decoy, suppress_candidates
    from .align.pipeline import align_and_count
    from .align.seed import ChainParams, seed_candidates
    from .config import GenotypeConfig
    from .dist import decoy_shard as ds
    from .dist.engine import (
        assert_no_group_straddle, dp_filter_count_v3,
        make_sharded_count_step_v3,
    )
    from .dist.mesh import local_devices, make_mesh

    if devices is None:
        devices = local_devices(select_device())
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    graph_shards = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(
        data_shards=n_devices // graph_shards, graph_shards=graph_shards,
        devices=devices,
    )
    data_shards = mesh.shape["data"]
    root = mesh.devices[0, 0]

    # ---- 1. sharded count step == one-device counts ----
    prob = production_problem(pad_to=128, data_shards=data_shards,
                              device=root)
    _check(all(prob["real_per_shard"]),
           "every data shard must hold real candidates so the dry run "
           f"counts on every shard: {prob['real_per_shard']}")
    assert_no_group_straddle(prob["group"], prob["meta"], data_shards)
    rw, rn, pw, pn = prob["data"].packed_words()
    step = make_sharded_count_step_v3(
        mesh,
        bucket=prob["bucket"], band=prob["band"], params=prob["params"],
        n_groups_per_shard=prob["n_groups"], n_tags=prob["n_tags"],
        # The kernels on a card, their plain versions on the CPU; the
        # one-pass engine gives the one-device truth either way.
        engine="v3i" if root.type == "cpu" else "v3",
    )
    counts = step(
        rw, rn, pw, pn, prob["meta"], prob["path_start"], prob["group"],
        prob["cand_path"], prob["owned"],
    ).cpu().numpy()
    _check(counts.shape == (prob["n_tags"], 2), f"shape {counts.shape}")
    ref = dp_filter_count_v3(
        rw, rn, pw, pn, prob["meta"], prob["path_start"], prob["group"],
        prob["cand_path"], prob["owned"],
        bucket=prob["bucket"], band=prob["band"], params=prob["params"],
        n_groups=prob["n_groups"], n_tags=prob["n_tags"], engine="xla",
    )["counts"].cpu().numpy()
    np.testing.assert_array_equal(counts, ref)
    _check(counts.sum() > 0, "dry run must count real support")

    # ---- 2. align_and_count, data-parallel over the mesh's devices ----
    reads, panel, index, cfg = (
        prob["reads"], prob["panel"], prob["index"], prob["cfg"]
    )
    gcfg = GenotypeConfig()
    chunk = max(1, -(-reads.n_reads // n_devices))
    sharded, _, _ = align_and_count(
        reads, panel, index, cfg, gcfg, device=root, collect_audit=False,
        devices=devices, chunk_reads=chunk,
    )
    single, _, _ = align_and_count(
        reads, panel, index, cfg, gcfg, device=root, collect_audit=False,
        chunk_reads=chunk,
    )
    _check(sharded == single, f"{sharded} != {single}")

    # ---- 3. decoy competition sharded over the graph axis ----
    # Genomic-range decoy shards must reproduce the unsharded suppression
    # margins exactly; the per-shard claimed-chain counts, each on its
    # graph shard's device, summed on devices[0, 0], must give the
    # unsharded chain count.
    cp = ChainParams()
    decoy = build_decoy(
        panel, k=cfg.kmer, w=cfg.window,
        max_hits_per_minimizer=cfg.max_hits_per_minimizer,
    )
    cands = seed_candidates(reads, index, chain_params=cp)
    keep_u, other_u, same_u = suppress_candidates(
        reads, cands, index, decoy, cp, return_margins=True
    )
    shards = ds.split_decoy(decoy, 2, margin=8192)
    keep_s, other_s, same_s = ds.suppress_candidates_sharded(
        reads, cands, index, shards, cp
    )
    np.testing.assert_array_equal(other_s, other_u)
    np.testing.assert_array_equal(same_s, same_u)
    np.testing.assert_array_equal(keep_s, keep_u)

    total = torch.zeros((), dtype=torch.int64, device=root)
    for g, sh in enumerate(
            ds.split_decoy(decoy, mesh.shape["graph"], margin=8192)):
        dec_g = seed_candidates(reads, sh.decoy.index,
                                chain_params=ds._uncapped(cp))
        dec_g = ds.claim_owned_chains(dec_g, reads, sh)
        n_chains = len(np.unique(dec_g.chain)) if len(dec_g) else 0
        total += torch.tensor(n_chains, device=mesh.devices[0, g]).to(root)
    dec_all = seed_candidates(reads, decoy.index,
                              chain_params=ds._uncapped(cp))
    n_all = len(np.unique(dec_all.chain))
    _check(int(total) == n_all, f"{int(total)} != {n_all}")
