# Copied verbatim from svjedi_tpu/config.py.
"""Single typed configuration for the whole pipeline.

The reference spreads its knobs over four argparse parsers with several dead
or broken flags (SURVEY §5.6: svjedi-graph.py:28-79 ``-t`` default broken,
filter-alignments.py:52-57 ``-O`` broken, :45-50 ``-i`` unused). Here every
stage reads one dataclass; the CLI maps the reference's flag names onto it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Knobs of the seed-chain-extend panel aligner (minigraph replacement)."""

    # Minimizer seeding (minimap2/minigraph-style long-read defaults).
    kmer: int = 15
    window: int = 10
    #: Drop minimizers occurring more often than this in the panel index.
    max_hits_per_minimizer: int = 64
    #: Minimum anchors for a chain to become a (read, path, strand) candidate.
    min_anchors: int = 2
    #: Diagonal rounding legacy knob (kept for the dist demo path).
    diag_bin: int = 64

    # Anchor chaining (the drift-following replacement for diagonal binning:
    # a 10%-error 8 kb read drifts ~300 bases off its seed diagonal, far
    # beyond the DP band, so one fixed-diagonal window truncates the
    # alignment; chains follow the drift and are cut into per-block DP
    # problems with per-block diagonals).
    #: Max chains kept per (read, path, strand), by anchor count.
    max_chains: int = 4
    #: Max read-coordinate gap between consecutive anchors of a chain.
    chain_max_gap: int = 4096
    #: Diagonal drift tolerance between consecutive anchors: abs + rate*gap.
    chain_drift_abs: int = 64
    #: Drift rate tolerance in permille of the read-coordinate gap.
    chain_drift_permille: int = 150
    #: Read rows per chain block (one DP problem per block); the block's
    #: internal drift must stay within band/2 of the block-median diagonal.
    block_rows: int = 1536
    #: Chains with at least this many anchors get one extension block on
    #: each side (alignment can extend past the outermost anchors).
    chain_ext_min_anchors: int = 4

    #: Whole-genome decoy competition: suppress a panel chain whose read
    #: interval is better explained by a chain elsewhere in the genome
    #: (minigraph's whole-graph primary selection; align/decoy.py).
    decoy: bool = True

    #: Run the minimizer scan on the device (align/dev_scan.py), leaving
    #: only lookup + chaining on the host. Falls back to the native host
    #: scan when the native chainer is unavailable or the scan output
    #: overflows its capacity class.
    device_seed: bool = True

    # Banded affine-gap DP (scores in the minimap2 convention).
    match: int = 2
    mismatch: int = -4
    gap_open: int = -4
    gap_extend: int = -2
    #: DP band width in bases (lanes); multiple of 128.
    band: int = 128
    #: Minimum winning DP score for an alignment to be counted at all.
    min_score: int = 40
    #: Minimum score per aligned base (x1000) for a winner to be counted:
    #: a real long-read alignment scores ~match*(1-3e) per base (~1.4 at
    #: 10% error with +2/-4), while repeat-shift junk runs far below; the
    #: reference gets this filter from minigraph's own alignment scoring.
    min_density_millis: int = 500
    #: Read/path length buckets for fixed-shape batching.
    buckets: tuple = (512, 1024, 2048, 4096, 8192, 16384, 30720)

    # Panel construction.
    #: Flank length (bases) kept on each side of a junction cluster.
    flank: int = 600
    #: Breakpoints closer than this merge into one junction cluster.
    cluster_gap: int = 500
    #: Caps on local path enumeration per cluster.
    max_paths_per_cluster: int = 64
    max_hops_per_path: int = 24

    #: Host threads for native seeding/minimizer scans (``-t``; 0 = all
    #: hardware threads, matching minigraph's ``-t`` at svjedi-graph.py:104).
    threads: int = 0

    # Device-memory budgeting (align/pipeline.py pending-chunk flush cap).
    #: Device HBM bytes. 0 = query the device's ``memory_stats()`` at run
    #: time, falling back to 16 GiB (the v5e this was tuned on) when the
    #: backend reports none.
    hbm_bytes: int = 0
    #: Fraction of HBM budgeted for pending chunk *input* buffers (fwd+rc
    #: read codes + packed words held until their flush); panel/decoy
    #: buffers, DP metadata and result arrays share the rest. 6 GB of a
    #: 16 GB v5e measured safe at the 250 Mb scale config (PERF.md).
    pending_input_frac: float = 0.375


@dataclasses.dataclass(frozen=True)
class GenotypeConfig:
    """Genotype-model knobs (reference: predict-genotype.py:29-65)."""

    #: Minimum informative alignments to emit a genotype (``-ms``, default 3).
    min_support: int = 3
    #: Allele error probability e (``-e``, default 5e-5).
    err: float = 0.00005
    #: Required aligned bases on each side of a crossed junction
    #: (filter-alignments.py d_over, effectively fixed at 100).
    d_over: int = 100
    #: Minimum winner score density (score / target span) for an
    #: alignment to contribute crossings. The analog of minigraph's
    #: chain-quality admission (the reference pipeline itself has no such
    #: rule — minigraph simply never emits the low-density alignments):
    #: with match=+2 scoring, a clean long-read alignment at ~10% error
    #: scores ~1.2-1.5/base; winners below ~1.1 are discontinuity
    #: bridges whose middle never aligned (see PARITY.md attribution
    #: table — cutting them removes over-counts only, verified zero
    #: under-counts vs the golden bundle). 0 disables. Not applied in
    #: the external-GAF path (reference filter semantics are exact).
    #: CALIBRATION DOMAIN: the 1.1 default is a fraction (0.55) of the
    #: default match=+2 DP score, validated on the golden bundle's ~10%
    #: simulated error; pipelines resolve the effective threshold through
    #: :func:`resolve_min_count_density`, which scales it with
    #: ``AlignConfig.match`` so a rescored aligner keeps the same
    #: *relative* gate instead of silently over- or under-gating.
    min_count_density: float = 1.1


#: Match score the ``min_count_density`` default was calibrated against
#: (PARITY.md's experiment table; golden bundle, ~10% simulated error).
DENSITY_CALIBRATED_MATCH = 2

_density_scale_warned = False


def resolve_min_count_density(
    genotype: "GenotypeConfig", align: "AlignConfig"
) -> float:
    """Effective count-density threshold, coupled to the DP match score.

    The density gate measures score per target base, so its meaning is a
    fraction of ``AlignConfig.match`` (1.1 == 0.55 x match=2). A pipeline
    run with a different match score keeps the same fraction — applying the
    absolute 1.1 under e.g. match=1 scoring would silently drop genuine SV
    support (ADVICE r4). Scaling is announced once on stderr.
    """
    d = genotype.min_count_density
    if d <= 0:
        return 0.0
    if align.match == DENSITY_CALIBRATED_MATCH:
        return d
    scaled = d * align.match / DENSITY_CALIBRATED_MATCH
    global _density_scale_warned
    if not _density_scale_warned:
        import sys

        print(
            f"[config] note: min_count_density={d} is calibrated for "
            f"match=+{DENSITY_CALIBRATED_MATCH} scoring; with "
            f"match=+{align.match} the effective gate scales to "
            f"{scaled:.3f} (same fraction of the match score)",
            file=sys.stderr,
        )
        _density_scale_warned = True
    return scaled


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Device-mesh layout (SURVEY §2.2: the TPU-native scaling strategy)."""

    #: Number of data-parallel read shards: ``run_pipeline`` round-robins
    #: read chunks over this many local devices (``--data-shards``).
    data_shards: int = 1
    #: SV tag-space shards of the on-mesh count step (mesh axis ``graph``
    #: in dist/engine.py; exercised by the multichip dry run). The chunked
    #: production pipeline replicates the panel — use the on-mesh step for
    #: genomes whose tag table warrants sharding.
    graph_shards: int = 1
    #: Genomic-range shards of the whole-genome decoy index
    #: (dist/decoy_shard.py): the Gb-scale memory lever — a 3 Gb genome's
    #: ~550 M-hit table splits so each graph-axis host holds ~1/G of it.
    #: Byte-equal to the unsharded competition (tests/test_decoy_shard.py).
    #: In a single process all G shards are resident (equality/testing
    #: mode); the memory win realizes on a (data x graph) process grid
    #: where each host builds only its shard (build_decoy_shard).
    decoy_shards: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vcf: Optional[Path] = None
    ref: Optional[Path] = None
    #: Comma-separated FASTQ list is split like svjedi-graph.py:95-98.
    reads: tuple = ()
    prefix: str = "svjedi_tpu_out"

    align: AlignConfig = AlignConfig()
    genotype: GenotypeConfig = GenotypeConfig()
    dist: DistConfig = DistConfig()

    #: Multi-host data parallelism: (shard_index, shard_count). Each host
    #: runs the pipeline on its contiguous block of the read stream and
    #: writes ``<prefix>.shard{i}of{n}_informative_aln.json``; the
    #: ``merge`` CLI command sums the per-(SV, allele) counts — the only
    #: cross-read reduction — and genotypes (SURVEY §2.2). On a pod slice
    #: the same reduction rides a psum instead (dist/count_step.py).
    shard: Optional[tuple] = None
    #: jax.distributed multi-host mode (``--multihost``): join the process
    #: group, shard reads by process index, allreduce the count tables
    #: over the fabric, genotype on process 0 (dist/multihost.py). No
    #: shared filesystem needed, unlike ``shard``/``merge``.
    multihost: bool = False

    #: Stream reads from disk in O(chunk) memory (io.fastq.ReadStream, the
    #: Gb-genome loader) instead of loading them resident. None = auto:
    #: stream except in shard/multihost modes (which slice the read set by
    #: global index and therefore need it resident up front). Streamed and
    #: eager runs are byte-identical (tests/test_stream.py).
    stream_reads: Optional[bool] = None
    #: Preserve stage artifacts (gfa / edges json / informative-aln json) so
    #: stages are independently re-runnable (SURVEY §5.4 de-facto resume).
    keep_artifacts: bool = True
    #: Skip stages whose artifacts already exist.
    resume: bool = False
    #: Emit a GAF of winning alignments (interop/debug).
    write_gaf: bool = False
    #: Capture a JAX profiler trace into this directory.
    profile_dir: Optional[Path] = None
