"""End-to-end pipeline: VCF + FASTA + FASTQ → genotyped VCF, on PyTorch.

Counterpart of ``svjedi_tpu/pipeline.py`` with the same artifacts on disk
(``<prefix>.gfa``, ``<prefix>_svs_edges.json``, ``<prefix>_ignored_svs.txt``,
``<prefix>_informative_aln.json``, ``<prefix>_genotype.vcf``,
``<prefix>_stats.json``). The device is chosen once here and does not
change during a run: ``cuda:0`` unless the caller names the CPU; with no
card visible and no device named, the run raises.
The DP engine follows the device unless named (``align/pipeline.py``:
``resolve_engine``).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

from .align.index import build_panel_index
from .config import PipelineConfig
from .genotype.filter_gaf import (
    counts_from_informative,
    write_informative_json,
)
from .genotype.vcf_writer import write_genotyped_vcf
from .graph.build import (
    build_graph,
    write_gfa,
    write_ignored_svs,
    write_svs_edges_json,
)
from .graph.cluster import build_panel
from .graph.svparse import parse_vcf_svs
from .io.fasta import read_fasta
from .io.fastq import read_reads
from .utils.native import load_native
from .utils.stats import RunStats
from .align.pipeline import align_and_count, resolve_engine
from .kernels import band_dp_dma, band_dp_v3


def select_device() -> torch.device:
    """``cuda:0``; raises when no CUDA device is visible (the CPU is only
    ever run when a caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: svjedi_tpu_torch runs on the GPU "
            'unless asked for the CPU (device=torch.device("cpu"), or '
            "--device cpu on the command line)"
        )
    return torch.device("cuda:0")


def merge_shards(
    vcf,
    prefix: str,
    n_shards: int,
    out_vcf=None,
    min_support: int = 3,
    err: float = 0.00005,
) -> Dict:
    """Merge per-host shard audit tables and genotype once.

    The only cross-read state in the pipeline is the per-(SV, allele)
    alignment list, so the reduction is a concatenation + count.
    """
    merged: Dict = {}
    for i in range(n_shards):
        path = f"{prefix}.shard{i}of{n_shards}_informative_aln.json"
        with open(path) as fh:
            part = json.load(fh)
        for tag, pair in part.items():
            entry = merged.setdefault(tag, [[], []])
            entry[0].extend(pair[0])
            entry[1].extend(pair[1])
    write_informative_json(merged, f"{prefix}_informative_aln.json")
    counts = counts_from_informative(merged)
    out_vcf = out_vcf or f"{prefix}_genotype.vcf"
    summary = write_genotyped_vcf(
        vcf, out_vcf, counts, min_support=min_support, err=err
    )
    return {"counts": counts, "output_vcf": out_vcf, "summary": summary}


def _not_ported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported to svjedi_tpu_torch yet: ROADMAP.md queue A, "
        f"{item}"
    )


def run_pipeline(
    cfg: PipelineConfig,
    device: Optional[torch.device] = None,
    engine: Optional[str] = None,
) -> Dict:
    """Run all stages on ``device`` (default: :func:`select_device`, the
    card) with the DP ``engine`` (default: ``gather`` on the CPU, ``v3`` on a
    card)."""
    if cfg.multihost:
        raise _not_ported("--multihost", "M10")
    if cfg.dist.data_shards > 1:
        raise _not_ported("--data-shards > 1", "M9")
    if cfg.dist.graph_shards > 1:
        raise _not_ported("--graph-shards > 1", "M9")
    device = device or select_device()
    engine = resolve_engine(engine, device)
    stats = RunStats()
    prefix = cfg.prefix
    stats.set("device", str(device))
    stats.set("engine", engine)
    if device.type == "cuda":
        stats.set("device_name", torch.cuda.get_device_name(device))

    with stats.timer("load_reference"):
        chroms = read_fasta(cfg.ref)
        chrom_lengths = {c: len(s) for c, s in chroms.items()}

    with stats.timer("construct_graph"):
        parsed = parse_vcf_svs(cfg.vcf, chrom_lengths)
        graph = build_graph(chroms, parsed)
    stats.set("n_svs", len(parsed.svs))
    stats.set("n_discarded_svs", len(parsed.discarded))
    stats.set("n_nodes", graph.n_nodes)
    stats.set("n_links", len(graph.links))
    if cfg.keep_artifacts:
        write_gfa(graph, f"{prefix}.gfa")
        write_svs_edges_json(graph, f"{prefix}_svs_edges.json")
        write_ignored_svs(parsed, f"{prefix}_ignored_svs.txt")

    # Stage-artifact resume: with an existing informative-aln JSON the
    # aligner is skipped and counts come from the audit table.
    informative_path = Path(f"{prefix}_informative_aln.json")
    if cfg.resume and informative_path.exists():
        with informative_path.open() as fh:
            audit = json.load(fh)
        counts = counts_from_informative(audit)
        stats.set("resumed_from", str(informative_path))
        with stats.timer("genotype"):
            out_vcf = f"{prefix}_genotype.vcf"
            summary = write_genotyped_vcf(
                cfg.vcf, out_vcf, counts,
                min_support=cfg.genotype.min_support, err=cfg.genotype.err,
            )
        stats.counters.update(summary)
        stats.dump(f"{prefix}_stats.json")
        return {"counts": counts, "stats": stats, "output_vcf": out_vcf}

    with stats.timer("build_panel"):
        panel = build_panel(
            graph,
            flank=cfg.align.flank,
            cluster_gap=cfg.align.cluster_gap,
            max_paths_per_cluster=cfg.align.max_paths_per_cluster,
            max_hops_per_path=cfg.align.max_hops_per_path,
        )
        index = build_panel_index(
            panel,
            k=cfg.align.kmer,
            w=cfg.align.window,
            max_hits_per_minimizer=cfg.align.max_hits_per_minimizer,
        )
    stats.set("n_clusters", len(panel.clusters))
    stats.set("n_panel_paths", panel.n_paths)
    stats.set("panel_bases", panel.total_bases())
    truncated = [cl.cluster_id for cl in panel.clusters if cl.truncated]
    stats.set("panel_truncated_clusters", len(truncated))
    if truncated:
        affected = sorted({
            t
            for cl in panel.clusters
            if cl.truncated
            for pi in cl.paths
            for (t, *_rest) in panel.paths[pi].owned
        })
        print(
            f"[panel] WARNING: {len(truncated)} cluster(s) hit the "
            f"haplotype-walk enumeration cap "
            f"(max_paths_per_cluster={cfg.align.max_paths_per_cluster}); "
            "per-SV fallback sub-panels keep every allele countable. "
            f"Affected SVs: {', '.join(affected[:12])}"
            + (" ..." if len(affected) > 12 else ""),
            file=sys.stderr,
        )
        stats.set("panel_truncated_svs", affected)

    decoy = None
    if cfg.align.decoy:
        if cfg.dist.decoy_shards > 1:
            from .dist.decoy_shard import build_decoy_shard

            G = cfg.dist.decoy_shards
            with stats.timer("build_decoy"):
                decoy = [
                    build_decoy_shard(
                        panel, G, g, k=cfg.align.kmer, w=cfg.align.window,
                        max_hits_per_minimizer=(
                            cfg.align.max_hits_per_minimizer
                        ),
                    )
                    for g in range(G)
                ]
            stats.set("decoy_shards", G)
            stats.set(
                "decoy_shard_hit_bytes", [s.hit_bytes() for s in decoy]
            )
        else:
            from .align.decoy import build_decoy

            with stats.timer("build_decoy"):
                decoy = build_decoy(
                    panel,
                    k=cfg.align.kmer,
                    w=cfg.align.window,
                    max_hits_per_minimizer=cfg.align.max_hits_per_minimizer,
                )

    # Read loading: streamed (O(chunk) resident) or eager. Shard mode
    # slices the read set by global index, so it loads eagerly.
    stream_mode = cfg.stream_reads
    if cfg.shard is not None:
        if stream_mode:
            print(
                "[pipeline] note: --shard needs the full read set "
                "resident; streaming disabled for this run",
                file=sys.stderr,
            )
        stream_mode = False
    elif stream_mode is None:
        stream_mode = True
    if stream_mode:
        from .io.fastq import ReadStream

        reads = ReadStream(cfg.reads)
        stats.set("read_loader", "stream")
    else:
        with stats.timer("load_reads"):
            reads = read_reads(cfg.reads)
            if cfg.shard is not None:
                i, n = cfg.shard
                lo = reads.n_reads * i // n
                hi = reads.n_reads * (i + 1) // n
                reads = reads.slice(lo, hi)
                stats.set("shard", f"{i}/{n}")
        stats.set("n_reads", reads.n_reads)
        stats.set("read_bases", int(reads.lengths.sum()))

    launches0 = band_dp_v3.launches
    rev_launches0 = band_dp_v3.rev_launches
    dma_launches0 = band_dp_dma.launches
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    profiler = contextlib.nullcontext()
    if cfg.profile_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    with profiler, stats.timer("align"):
        counts, audit, winners = align_and_count(
            reads, panel, index, cfg.align, cfg.genotype, device=device,
            decoy=decoy, engine=engine,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if cfg.profile_dir is not None:
        Path(cfg.profile_dir).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(cfg.profile_dir) / "trace.json"))
    stats.set("seed_path", "host")
    # The host library serves seeding and chaining; without it the numpy
    # path runs (kernels/build.py:build_native builds it). Recorded is the
    # file the loader opened.
    native = load_native()
    stats.set("native_lib", native._lib._name if native else None)
    stats.set("band_dp_v3_launches", band_dp_v3.launches - launches0)
    stats.set("band_dp_v3_rev_launches", band_dp_v3.rev_launches - rev_launches0)
    stats.set("band_dp_dma_launches", band_dp_dma.launches - dma_launches0)
    if device.type == "cuda":
        stats.set(
            "device_max_memory_allocated",
            int(torch.cuda.max_memory_allocated(device)),
        )
    if stream_mode:
        # Counts known only after the stream has been consumed.
        stats.set("n_reads", reads.n_reads)
        stats.set("read_bases", int(reads.total_bases))
    stats.set("n_winning_alignments", int(len(winners.read)))
    if winners.rescore_flag is not None:
        stats.set("n_audit_rescore_below", int(winners.rescore_flag.sum()))
    if cfg.write_gaf:
        from .align.gaf_out import write_gaf as _write_gaf

        _write_gaf(f"{prefix}.gaf", panel, winners, reads)
    stats.set(
        "n_informative_alignments",
        int(sum(sum(v) for v in counts.values())),
    )
    if cfg.shard is not None:
        # Shard mode: emit this host's audit table and stop — merging and
        # genotyping happen once, via the ``merge`` command.
        i, n = cfg.shard
        shard_path = f"{prefix}.shard{i}of{n}_informative_aln.json"
        write_informative_json(audit, shard_path)
        stats.dump(f"{prefix}.shard{i}of{n}_stats.json")
        return {"counts": counts, "stats": stats, "shard_json": shard_path}
    if cfg.keep_artifacts:
        write_informative_json(audit, f"{prefix}_informative_aln.json")

    with stats.timer("genotype"):
        out_vcf = f"{prefix}_genotype.vcf"
        summary = write_genotyped_vcf(
            cfg.vcf,
            out_vcf,
            counts,
            min_support=cfg.genotype.min_support,
            err=cfg.genotype.err,
        )
    stats.counters.update(summary)
    stats.dump(f"{prefix}_stats.json")
    return {
        "counts": counts,
        "stats": stats,
        "output_vcf": out_vcf,
    }
