"""Profile of the native seed stage on a bundle: scan against lookup + chain.

    python -m svjedi_tpu_torch.profile_seed [--cpu]

The counterpart of the JAX package's ``tools/profile_seed.py``, run with
this package's own modules on the bundle in :data:`TEST_DIR`
(``SVJT_TESTDIR``, as ``profile_seed5``). It builds the merged panel +
decoy index, tiles the reads ``SVJT_BENCH_REPS`` times (10 by default, as
the golden bench does) and times, on the host only:

1. three trials of the native minimizer scan with the index's prefilter
   bitmap (``scan_bitmap``, ``kept`` minimizers), the native scan + exact
   lookup + chaining ``svt_chain2`` (``chain2``, ``blocks``) and the raw
   scan without the bitmap (``scan_raw``, ``minimizers``), so that chain2
   less scan_bitmap is the lookup and chaining;
2. two trials of the full seed as the pipeline calls it:
   ``seed_candidates`` (``seed_candidates``) and the decoy competition
   ``suppress_candidates`` (``suppress``), with the panel and decoy
   candidate counts (``n_panel``, ``n_dec``).

Output: one JSON line. The tool uses no device; like the port's other
tools it runs where a card is visible and refuses otherwise unless given
``--cpu``, and the line names the device it was given. Without the bundle
it raises, naming the missing file.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .bench import tile_reads
from .profile_seed5 import (TEST_DIR, _timed, build_seed_inputs, chain_params,
                            require_native)


class Measurement(NamedTuple):
    line: dict  # the JSON line
    panel_cands: object  # Candidates of the last full trial's panel rows
    keep: np.ndarray  # its suppression mask


def measure(ref, vcf, reads_path, device: torch.device, *,
            reps: Optional[int] = None) -> Measurement:
    """The profile on the bundle (``ref``, ``vcf``, ``reads_path``), its
    reads tiled ``reps`` times (None: ``SVJT_BENCH_REPS``, default 10).
    ``device`` only names where the tool was asked to run."""
    from .align.decoy import suppress_candidates
    from .align.index import merge_indexes
    from .align.seed import seed_candidates

    if reps is None:
        reps = int(os.environ.get("SVJT_BENCH_REPS", "10"))
    cfg, _, index, decoy, base = build_seed_inputs(ref, vcf, reads_path)
    native = require_native()
    seed_index = merge_indexes(index, decoy.index)
    n_panel = len(index.path_len)
    reads = tile_reads(base, reps)
    cp = chain_params(cfg)

    trials = []
    for _ in range(3):
        mins, t_scan = _timed(lambda: native.minimizers(
            reads.codes, reads.offsets, seed_index.k, seed_index.w,
            bitmap=seed_index.hash_bitmap(),
            bitmap_log2=seed_index.BITMAP_LOG2, n_threads=0))
        res, t_chain = _timed(lambda: native.chain(
            reads.codes, reads.offsets, seed_index.k, seed_index.w,
            bitmap=seed_index.hash_bitmap(),
            bitmap_log2=seed_index.BITMAP_LOG2,
            uniq_hash=seed_index.uniq_hash, hit_start=seed_index.hit_start,
            hit_path=seed_index.hit_path, hit_pos=seed_index.hit_pos,
            hit_strand=seed_index.hit_strand, params=cp, n_threads=0,
            panel_path_limit=n_panel))
        raw, t_raw = _timed(lambda: native.minimizers(
            reads.codes, reads.offsets, seed_index.k, seed_index.w,
            n_threads=0))
        trials.append({"scan_bitmap": t_scan, "kept": len(mins[0]),
                       "chain2": t_chain, "blocks": len(res[0]),
                       "scan_raw": t_raw, "minimizers": len(raw[0])})

    full = []
    for _ in range(2):
        cands, t_seed = _timed(lambda: seed_candidates(
            reads, seed_index, chain_params=cp, threads=0,
            panel_path_limit=n_panel))

        def suppress():
            is_panel = cands.path < n_panel
            dec = cands.take(~is_panel, path_offset=-n_panel)
            pcands = cands.take(is_panel)
            return pcands, dec, suppress_candidates(
                reads, pcands, index, decoy, cp, threads=0, dec=dec)

        (pcands, dec, keep), t_supp = _timed(suppress)
        full.append({"seed_candidates": t_seed, "suppress": t_supp,
                     "n_panel": len(pcands), "n_dec": len(dec)})

    line = {
        "device": str(device),
        "reads": int(reads.n_reads),
        "bases": int(reads.codes.size),
        "index_hits": int(len(seed_index.hit_path)),
        "uniq": int(len(seed_index.uniq_hash)),
        "trials": trials,
        "full": full,
    }
    return Measurement(line, pcands, keep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m svjedi_tpu_torch.profile_seed",
        description="Profile of the native seed stage on the bundle in "
                    f"{TEST_DIR}.")
    ap.add_argument("--cpu", action="store_true",
                    help="accept a machine without a card (the tool uses "
                         "the host only)")
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
