"""Per-chunk profile of the device-seed path on a bundle.

    python -m svjedi_tpu_torch.profile_seed5 [--cpu]

The counterpart of the JAX package's ``tools/profile_seed5.py``, run with
this package's own modules on the bundle in :data:`TEST_DIR`
(``SVJT_TESTDIR``: ``reference_genome.fasta``, ``test.vcf``,
``simulated_reads.fastq.gz``). It times the pieces of a chunk's seeding as
``align_and_count`` runs them (its ``pull`` and ``seed_chunk``):

1. ``dev.upload(..., offsets=)`` of the chunk (``upload``);
2. ``dev_scan.dispatch_scan``, host time to return (``dispatch``);
3. ``dev_scan.fetch_bitmask``, host time to the bitmask (``fetch``);
4. ``seed_candidates(..., bits=)``: lookup and chaining from the bitmask,
   native ``svt_chain5`` (``chain5``; ``n_cands`` candidates);
5. the panel/decoy split and ``suppress_candidates(...,
   return_margins=True)`` (``suppress``);

and on a card the scan kernel's own time (``d1_ms``, CUDA events around
its launch; None on the CPU) and launches. The merged panel + decoy index
builds its native lookup table, its prefilter bitmap and its packed hits
lazily, on the first chunk's seed: they are timed apart on one index
(``lookup_prebuild_s``, ``bitmap_build_s``, ``packed_hits_build_s``),
while iteration 0 runs on a fresh index and a fresh panel cache, as
``run``'s first chunk does, and is reported apart (``cold``) from the
best of the later iterations (``warm``, each field's minimum). Then the
chain alone on the host bitmask with 1, 2 and 4 threads, best of 3
(``chain5_threads_{1,2,4}``), and the host-scan path, ``seed_candidates``
without ``bits`` (``host_scan_chain``, ``n_cands_host_scan``). ``main``
profiles all the bundle's reads as one chunk, as the JAX tool does;
:func:`measure` takes the first ``n_reads``. Two more pieces of the host
work before ``run``'s first device call are timed: building the merged
index (``merge_indexes_s``) and streaming the first chunk from the reads
file at ``align_and_count``'s chunk sizes (``stream_first_chunk_s``: the
stream buffers a full chunk and one read before it yields the quarter
chunk).

Output: one JSON line. It runs on ``cuda:0`` and refuses to run without a
card unless given ``--cpu``, where the scan's plain version runs; without
the bundle it raises, naming the missing file.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .bench_scaling import TEST_DIR as _REFERENCE_BUNDLE

TEST_DIR = Path(os.environ.get("SVJT_TESTDIR", _REFERENCE_BUNDLE))

#: The timed fields of one iteration, named after the JAX tool's.
ITER_KEYS = ("upload", "dispatch", "fetch", "chain5", "suppress")
#: The candidate arrays that must agree between the two seed paths.
CAND_FIELDS = ("read", "path", "strand", "d0", "n_anchors", "chain", "q_lo",
               "q_hi", "a_lo", "a_hi")
THREADS = (1, 2, 4)
#: ``align_and_count``'s default chunk and first-chunk sizes.
CHUNK_READS = 16384
FIRST_CHUNK_READS = max(256, CHUNK_READS // 4)


class Measurement(NamedTuple):
    line: dict  # the JSON line
    device_cands: object  # Candidates of the last device-scan iteration
    host_cands: object  # Candidates of the host-scan path
    d1_launches: int  # scan kernel launches of the iterations


def differing_fields(a, b) -> list:
    """The :data:`CAND_FIELDS` in which two Candidates differ."""
    return [f for f in CAND_FIELDS
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def build_seed_inputs(ref, vcf, reads_path, n_reads: Optional[int] = None):
    """Panel, panel index, decoy and the reads (the first ``n_reads``) of a
    bundle, built as ``run_pipeline`` builds them."""
    from .align.decoy import build_decoy
    from .align.index import build_panel_index
    from .config import AlignConfig
    from .graph.build import build_graph
    from .graph.cluster import build_panel
    from .graph.svparse import parse_vcf_svs
    from .io.fasta import read_fasta
    from .io.fastq import read_reads

    cfg = AlignConfig()
    chroms = read_fasta(ref)
    parsed = parse_vcf_svs(vcf, {c: len(s) for c, s in chroms.items()})
    panel = build_panel(build_graph(chroms, parsed), flank=cfg.flank,
                        cluster_gap=cfg.cluster_gap,
                        max_paths_per_cluster=cfg.max_paths_per_cluster)
    index = build_panel_index(
        panel, k=cfg.kmer, w=cfg.window,
        max_hits_per_minimizer=cfg.max_hits_per_minimizer)
    decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                        max_hits_per_minimizer=cfg.max_hits_per_minimizer)
    reads = read_reads(str(reads_path))
    if n_reads is not None and n_reads < reads.n_reads:
        reads = reads.slice(0, n_reads)
    return cfg, panel, index, decoy, reads


def chain_params(cfg):
    from .align.seed import ChainParams

    return ChainParams(min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
                       max_gap=cfg.chain_max_gap,
                       drift_abs=cfg.chain_drift_abs,
                       drift_permille=cfg.chain_drift_permille,
                       block_rows=cfg.block_rows,
                       ext_min_anchors=cfg.chain_ext_min_anchors)


def require_native():
    """The port's native host library, or RuntimeError: without it the
    seed stage runs its numpy path, which is not what these tools time."""
    from .utils.native import load_native

    native = load_native()
    if native is None:
        raise RuntimeError(
            "the port's native library is not loaded: build it with "
            "svjedi_tpu_torch/kernels/build.py:build_native")
    return native


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def measure(ref, vcf, reads_path, device: torch.device, *,
            n_reads: Optional[int] = None, iters: int = 4) -> Measurement:
    """The profile of the first ``n_reads`` reads (all: None) of the bundle
    (``ref``, ``vcf``, ``reads_path``) as one chunk on ``device``,
    ``iters`` iterations (at least 2: a cold one and a warm one)."""
    from .align import dev_scan
    from .align import device as dev
    from .align.decoy import suppress_candidates
    from .align.index import merge_indexes
    from .align.seed import seed_candidates
    from .io.fastq import ReadStream
    from .kernels import dev_scan as kscan

    if iters < 2:
        raise ValueError(f"iters must be at least 2, got {iters}")
    cfg, panel, index, decoy, chunk = build_seed_inputs(ref, vcf, reads_path,
                                                        n_reads)
    require_native()
    cp = chain_params(cfg)
    n_panel = len(index.path_len)

    # The lazy builds of the merged index, each timed on its own.
    combo, merge_s = _timed(lambda: merge_indexes(index, decoy.index))
    _, lookup_s = _timed(combo.native_lookup)
    _, bitmap_s = _timed(combo.hash_bitmap)
    _, packed_s = _timed(combo.packed_hits)

    on_card = device.type == "cuda"
    seed_index = merge_indexes(index, decoy.index)  # cold for iteration 0
    panel_cache: dict = {}
    launches0 = kscan.launches
    events = [] if on_card else None
    rows = []
    kscan.launch_events = events
    try:
        for _ in range(iters):
            dd, t_up = _timed(lambda: dev.upload(
                chunk.codes, panel, device, panel_cache,
                offsets=chunk.offsets))
            scan_out, t_disp = _timed(
                lambda: dev_scan.dispatch_scan(dd, seed_index.k,
                                               seed_index.w))
            bits, t_fetch = _timed(lambda: dev_scan.fetch_bitmask(scan_out))
            cands, t_chain = _timed(lambda: seed_candidates(
                chunk, seed_index, chain_params=cp, threads=cfg.threads,
                panel_path_limit=n_panel, bits=bits))

            def suppress():
                is_panel = cands.path < n_panel
                dec = cands.take(~is_panel, path_offset=-n_panel)
                return suppress_candidates(
                    chunk, cands.take(is_panel), index, decoy, cp,
                    threads=cfg.threads, dec=dec, return_margins=True)

            _, t_supp = _timed(suppress)
            rows.append({"upload": t_up, "dispatch": t_disp,
                         "fetch": t_fetch, "chain5": t_chain,
                         "suppress": t_supp, "n_cands": len(cands),
                         "d1_ms": None})
    finally:
        kscan.launch_events = None
    d1_launches = kscan.launches - launches0
    if on_card:
        torch.cuda.synchronize(device)
        for row, (start, end) in zip(rows, events):
            row["d1_ms"] = start.elapsed_time(end)
    warm = {key: min(r[key] for r in rows[1:]) for key in ITER_KEYS}
    warm["d1_ms"] = min(r["d1_ms"] for r in rows[1:]) if on_card else None

    # The chain alone on the host bitmask, by thread count.
    sweep = {}
    for thr in THREADS:
        sweep[f"chain5_threads_{thr}"] = min(
            _timed(lambda: seed_candidates(
                chunk, seed_index, chain_params=cp, threads=thr,
                panel_path_limit=n_panel, bits=bits))[1]
            for _ in range(3))
    host_cands, t_host = _timed(lambda: seed_candidates(
        chunk, seed_index, chain_params=cp, threads=cfg.threads,
        panel_path_limit=n_panel))
    _, stream_s = _timed(lambda: next(iter(ReadStream(reads_path).chunks(
        CHUNK_READS, first=FIRST_CHUNK_READS))))

    line = {
        "device": str(device),
        "n_reads": int(chunk.n_reads),
        "merge_indexes_s": merge_s,
        "lookup_prebuild_s": lookup_s,
        "bitmap_build_s": bitmap_s,
        "packed_hits_build_s": packed_s,
        "cold": rows[0],
        "warm": warm,
        "iters": rows,
        **sweep,
        "host_scan_chain": t_host,
        "n_cands_host_scan": len(host_cands),
        "stream_first_chunk_s": stream_s,
        "d1_launches": d1_launches,
    }
    return Measurement(line, cands, host_cands, d1_launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m svjedi_tpu_torch.profile_seed5",
        description="Per-chunk profile of the device-seed path on the "
                    f"bundle in {TEST_DIR}.")
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
    from .kernels import build

    build.build_native()
    result = measure(TEST_DIR / "reference_genome.fasta",
                     TEST_DIR / "test.vcf",
                     TEST_DIR / "simulated_reads.fastq.gz", device)
    print(json.dumps(result.line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
