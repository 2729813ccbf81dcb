#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught and continued):

1. Device: a CUDA device must be visible; prints its name, the
   ``nvidia-smi`` name and power limit, and the int32 peak (SMs x 64 lanes x
   the max SM clock) that the kernels' bounds use. Builds the port's native
   host library (``svjedi_tpu_torch/native/fastio.cpp``) and the CUDA
   kernels (``svjedi_tpu_torch/kernels/csrc``: the DP kernels, the audit's
   stats DP, the gather engine's DP and the minimizer scan), prints
   ptxas's registers and
   spills for each build (or that the library was cached) and the DPX
   instructions in the SASS of K1/K1' (8 builds), K3 (4), K4 (4), A1
   (12: 6 pre-gathered, 6 fused fetch) and G1 (6); fails if a K1/K1' build or a narrow K3, K4, A1 or G1
   build has no DPX add-max (VIADDMNMX).
2. Kernel vs plain: the band_dp_v3 kernel (K1) against its plain PyTorch
   version on the same CUDA tensors, exactly, at every bucket of
   ``AlignConfig.buckets`` with band 128 and at bucket 2048 with band 256
   (P = 256), at a production-shaped batch (P = 32768, bucket 2048), with
   and without row bounds, with ``n_valid < P`` and on edge cases; the
   two-pass wrapper likewise; the reverse kernel (K1') against
   ``band_dp_v3_rev_ref`` (flip + roll + the plain forward pass) in each of
   those cases, on raw windows (derived m, n_valid < P) and on end-clamped
   windows (m = qe + 1 and derived m); both kernels' wide build (scores
   that match x bucket or int8 cannot hold) at bucket 30720 and at band
   256; K1 and K1' at mismatch 100 (scores pass 2^16: wide build), at open
   + extend 1 and at extend 1 (bucket 2048, bands 128 and 256), where K1'
   runs every row. At P = 32768, bucket 2048 times K1, K1' alone, the flipped-window
   reverse pass it replaced (flip + roll + the forward kernel) and the
   plain versions, with Gcell/s, the bound and the share of the bound.
2b. One-pass kernels vs plain, exactly, at every bucket with band 128 and
   at bucket 2048 with band 256 (P = 256): the pre-gathered entry
   (``band_dp_onepass``, the same edge cases) and the fused-fetch entry
   (``band_dp_dma_raw``) on real upload buffers (forward and reverse-strand
   windows, windows crossing the path bounds, m < bucket, padding rows with
   m = 0); at bucket 2048 also both with a zero gap open (gap_open 2,
   gap_extend -2, where trailing sentinel rows can move the result, so
   every row runs), both wide builds (mismatch -200, and mismatch 100,
   whose scores pass 2^16), K3 with m = 0 beside m = bucket, K4 with an
   all-sentinel read row beside a full one in each warp, and K4's byte row
   scan (M = 2056; q at an 8-byte offset); both at P = 32768, bucket 2048,
   timed against their plain
   versions and their bounds.
2c. Pre-gathered path: the windows of phase 2b's production batch fetched
   on the card (``gather_windows``) and scored by ``band_dp_onepass``; the
   result must equal the fused-fetch kernel's on the same problems.
   Then the 10 Mb / 1,000 SV / 20x configuration is simulated (the scale
   config's seeds) for the phases below.
2f. The gather engine's DP (G1, ``band_dp_gather``) against its plain
   version (``band_dp_gather_ref``) on the same CUDA tensors, exactly
   (score, qs, ts, qe, te), at every bucket with band 128 and at bucket
   2048 with bands 256 and 512 (P = 256): ragged m, an all-sentinel read
   row and an all-sentinel target row, problems scoring 0, padding rows
   (all sentinel) at the end, tandem repeats and two equal local
   alignments, where the row rule (G1's) and the per-cell rule (K1's, K4's)
   pick different spans: G1 must differ from K4 on at least one problem;
   at bucket 2048 also a zero gap open and a positive mismatch (every row
   runs) and both wide builds (mismatch -200, and mismatch 100). Then at
   P = 32768, bucket 2048, band 128 times G1 and the plain version, with
   the bound.
2d. The minimizer scan (D1, ``dev_scan``: the sliding-window design)
   against its plain version, bit for bit, at k/w 15/10 and 11/5 on edge-case reads (N runs, palindromes,
   reads of 5, k - 1, k, k + w - 2 and k + w - 1 bases, an empty read,
   reads ending on tile edges and straddling them, code counts that are
   not multiples of 8), and through ``dispatch_scan``'s pinned copy; then
   on a full production chunk of the simulated reads (16,384 reads):
   bit-equal to the plain version, its set bits equal to the native host
   emission, ``seed_candidates(bits=...)`` equal to the host scan's
   candidates; times the kernel and the plain version, with the bound.
2e. The audit's stats DP (A1, ``band_dp_stats``) against its plain version
   (``band_dp_stats_ref``) on the same CUDA tensors, exactly (score,
   matches, n_diag, qe, te), at buckets 512, 1024 and 2048 with band 256
   and at bucket 2048 with band 512: ragged pieces, an all-sentinel read
   row and an all-sentinel target row, tandem repeats (tied maxima across
   rows and band offsets), two equal local alignments that the row rule
   and the per-cell rule tell apart; at bucket 2048 also a zero gap open
   and a positive mismatch (every row runs) and the wide build (mismatch
   -200). Then ``compute_winner_stats`` on the winners of one production
   chunk (16,384 reads of the 10 Mb bundle) on the card two ways, both on
   the chunk's uploaded buffers: fused (A1's fused-fetch entry,
   ``band_dp_stats_flat``, fetches every piece) and with the plain version
   on ``gather_windows``' windows of the same pieces: matches, blocklen,
   rescore_deficit and rescore_flag equal; each path's time and split.
   The fused entry on that chunk's pieces of every bucket, exactly against
   the plain version on ``gather_windows``' windows, at bands 256 and 512,
   narrow and wide (mismatch -200). At the production shape (that chunk's
   bucket-2048 pieces, their windows gathered: its first 4,096 and the
   whole bucket, band 256) checks A1's pre-gathered entry exactly and
   times it, the fused entry on the whole bucket and the plain version,
   with the bound.
3. Main path: runs ``python -m svjedi_tpu_torch run`` on the simulated
   bundle as a subprocess (the card, the v3 engine, with ``--gaf``). It
   must exit 0, genotype at accuracy 100.0, launch the forward and the
   reverse kernel and the audit's stats kernel (A1, every audit piece
   fetched by its fused entry), seed from the device scan with one scan
   launch per chunk, load the port's own native library, and print none
   of the aligner's fault warnings.
4. One-pass path: ``run_pipeline(..., engine="dma")`` in this process on
   phase 3's files, gated like phase 3, with band_dp_dma launches > 0,
   band_dp_v3 launches == 0 and A1 launches > 0; prints its align stage, reads/s, peak device
   memory, the VCF records that differ from phase 3's, and per winner field
   (GAF spans, score, mapq) how many winners the two engines disagree on.
4b. Gather path: ``run_pipeline(..., engine="gather")`` in this process on
   phase 3's files, gated like phase 4, with G1 launches > 0, K1, K1' and
   K3 launches == 0 and A1 launches > 0; prints what phase 4 prints.
5. Bench: ``SVJT_BENCH_CONFIG=scale python -m svjedi_tpu_torch.bench`` as
   a subprocess; it must exit 0 and print one JSON line with a positive
   ``scale_reads_per_s_per_chip``; its stderr timings are printed. With
   ``SVJT_SCALE_MEMLOG`` set to a file, that file must hold the JAX bench's
   header ``t_s rss_gb phase`` and the phase labels in its order (``sim``,
   ``sim_reads``, ``graph``, ``panel``, ``index``, ``decoy``,
   ``align_warm``, ``align_timed``, none after ``align_timed``), and the
   ``[scale]`` line ``post_align_resident_gb``; each label's peak RSS is
   printed.
6. Distribution layer, in this process, at full width: the production
   problem (``svjedi_tpu_torch.entry.production_problem``) built from the
   first 16,384 reads of the 10 Mb bundle (bucket 2048, candidates with
   m <= 2048, laid out for 2 data shards); the sharded count step
   (``dist/engine.py:make_sharded_count_step_v3``) on a 2 x 2 mesh of
   ``cuda:0`` with engine ``v3`` must launch K1 and K1' and equal
   ``dp_filter_count_v3(engine="v3i")`` (the plain versions, on the card)
   exactly, with a positive count; both timed, beside the one-device
   ``v3`` step. The one-device ``xla`` step (the dry run's truth, G1 on the
   card) must launch G1 and equal the same step on G1's plain version on
   the card in every output; its counts must equal the sharded ``v3``
   step's, or differ only through tied optima (every winner whose span or
   status moved keeps its score, and both engines' spans hold an optimal
   alignment). It is timed beside them, and so is its copy of the
   transposed windows.
   Then ``run_pipeline`` with ``--data-shards 2
   --graph-shards 2`` on four entries of ``cuda:0``, on phase 3's files:
   its VCF byte-equal to phase 3's, accuracy 100.0, ``data_shards`` 2,
   ``mesh`` "2x2", K1, K1' and A1 launched, ``seed_path`` "device", no
   fault warning.
7. Multihost: two processes of ``python -m svjedi_tpu_torch run
   --multihost`` in a gloo group on 127.0.0.1 (``MASTER_ADDR``,
   ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), both on ``cuda:0``, each
   aligning half of the reads, with a time limit that kills both; process
   0's VCF must equal a single-process run's byte for byte, and each
   process must launch A1. On the 10 Mb
   bundle (the single run is phase 3's) unless phase 3's wall time says
   the script would pass 1,000 s; then on a 1 Mb / 100 SV / 20x bundle
   with its own single run.

8. Every ``run`` mode not run on the card before, in this process through
   ``run_pipeline`` on cuda:0 against phase 3's run (its VCF and its
   audit table): ``--no-stream --no-artifacts`` (no read stream, no
   intermediate file), ``--shard 0/2`` and ``--shard 1/2 --decoy-shards
   2`` (``decoy_shards`` 2 in its stats) merged by ``python -m
   svjedi_tpu_torch merge -n 2``, ``--resume`` on a copy of phase 3's
   audit table (``resumed_from`` in its stats, no kernel launched) and
   ``--profile-dir`` (``trace.json`` written). Each VCF must equal phase
   3's byte for byte at accuracy 100.0 (on the 1 Mb bundle below, its
   single run's VCF at that run's accuracy); each run that aligns must launch
   K1, K1', A1 and D1 (one launch per chunk), load the port's native
   library and print no fault or audit warning. Each prints its align
   stage, wall time and peak device memory. From the trace: the device's
   busy share of the align stage (the union of its kernel, memcpy and
   memset intervals over the profiled window), the five kernels and the
   five longest idle gaps by time; the trace must hold CUDA kernel events,
   K1's, K1''s, D1's and A1's among them. On the 1 Mb bundle of phase 7
   (with its own single run) unless phase 3's wall time says the script
   would pass 1,000 s.
9. The port's ``python -m svjedi_tpu_torch.bench_scaling`` tool
   (``bench_scaling.measure``) on phase 3's bundle on cuda:0: its JSON
   line is printed with the JAX tool's keys, its problem count is a
   positive multiple of 1,024, K1 and K1' are launched, the one-device and
   the 1 x 1 sharded ``v3`` steps' counts are equal and positive, and the
   sharding overhead is finite.
10. The seed profilers on phase 3's bundle on cuda:0:
   ``profile_seed5.measure`` on the first 4,096 reads (``run``'s first
   chunk) and on the first 16,384 (a full chunk), and
   ``profile_seed.measure`` on all reads tiled once. Each profile's scan
   iterations must launch D1 at least once each, its device-scan
   candidates must equal its host-scan candidates array by array, and
   every time must be finite and positive; the cold and warm splits, the
   merged index's lazy builds, D1's own time, the chain's thread sweep and
   the host-scan path are printed.

Every phase prints its seconds. The kernels' launches in the JSON record
are those of one path's run each: phase 3 (`run`) for K1, K1', D1 and A1's
fused-fetch entry, phase 4 for K3, phase 2c for K4, phase 4b for G1, phase
2e's production-shape checks and timing for A1's pre-gathered entry; log
lines give the other paths', phases 8, 9 and 10 included.

Everything runs through ``svjedi_tpu_torch``; nothing of JAX or of the JAX
package is imported. The second-to-last line is the kernels' JSON record;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BAND = 128
FAULT_WARNINGS = (
    "reverse-pass scores disagree with forward pass",
    "failed; retrying",
    "bulk fetch failed",
)
AUDIT_WARNING = "audit re-scores fell well below"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# ---- phase 1 ----------------------------------------------------------------

#: H100 SXM memory rate (NVIDIA's data sheet), for the bytes side of a bound.
HBM_BYTES_PER_S = 3.35e12
#: int32 lanes per SM per clock on Hopper (4 partitions x 16).
INT32_LANES_PER_SM = 64
#: int32 operations per band cell as Hopper issues them. K1 (the v3
#: forward pass): add + viaddmax (V), prmt (substitution), viaddmax_relu
#: (H before the gap), viaddmax (lane-local F scan), viaddmax x2 (F
#: closure), imad + max (the packed best-cell key). The one-pass kernels (K3, K4)
#: add five selects that carry the start: vertical source, diagonal vs
#: vertical, reset at 0, horizontal source, best start. The audit's stats
#: DP (A1) adds to those one add: the diagonal step's increment. The
#: gather engine's DP (G1) runs K3/K4's cell.
OPS_PER_CELL = {"k1": 9, "onepass": 14, "stats": 15, "band_dp_gather": 14}
DPX_OPCODES = ("VIADDMNMX", "VIMNMX3", "VIMNMX")
#: (kernel name in the SASS, number of builds, regex of the builds that must
#: use VIADDMNMX). K1 and K1': forward and reverse x narrow and wide x band
#: 128 and 256; K3 and K4: narrow and wide x band 128 and 256, the narrow
#: builds (template flag kWide = false, mangled "Lb0E") checked; G1: narrow
#: and wide x band 128, 256 and 512; A1 likewise in each of its two entries,
#: pre-gathered (band_dp_stats_kernel) and fused fetch
#: (band_dp_stats_kernel_flat).
DPX_CHECKS = (
    ("band_dp_v3_kernel", 8, r"."),
    ("band_dp_dma_kernel", 4, r"band_dp_dma_kernelILi\d+ELb0E"),
    ("band_dp_onepass_kernel", 4, r"band_dp_onepass_kernelILi\d+ELb0E"),
    ("band_dp_stats_kernel", 12,
     r"band_dp_stats_kernel(_flat)?ILi\d+ELi\d+ELb0E"),
    ("band_dp_gather_kernel", 6, r"band_dp_gather_kernelILi\d+ELi\d+ELb0E"),
)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(smi_line)  # the card's name and power limit, as nvidia-smi prints them
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        max_sm_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no max SM clock: {clk.stdout!r} {clk.stderr!r}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peak_ops = n_sm * INT32_LANES_PER_SM * max_sm_hz
    log(f"[device] {n_sm} SMs, max SM clock {max_sm_hz / 1e6:.0f} MHz: int32 "
        f"peak {peak_ops / 1e12:.2f} Top/s; memory {HBM_BYTES_PER_S / 1e12} TB/s")

    from svjedi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    so = build.build_native()
    log(f"[build] native host library: {time.perf_counter() - t0:.2f} s -> "
        f"{so.relative_to(ROOT)}")
    t0 = time.perf_counter()
    build.load_library()
    log(f"[build] CUDA kernels: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s) -> "
        f"{build.library_path().relative_to(ROOT)}")
    if build.build_seconds == 0.0:
        log("[build] ptxas report unavailable: the kernels' library was "
            "cached, not rebuilt")
    for src in ("band_dp_v3.cu", "band_dp_onepass.cu", "band_dp_stats.cu",
                "band_dp_gather.cu", "dev_scan.cu"):
        for line in build.ptxas_report.get(src, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"[build] ptxas {src}: {line.strip()}")
    # Every K1 / K1' build must use DPX add-max, and so must the narrow
    # builds (kWide false) of K3, K4, A1 and G1; their wide builds are
    # printed only.
    for kernel, n_builds, must in DPX_CHECKS:
        found = dpx_in_sass(build.library_path(), kernel)
        for fn, ops in found.items():
            log(f"[build] SASS of {fn}: "
                + ", ".join(f"{op} {n}" for op, n in ops.items()))
        if len(found) != n_builds:
            fail(f"expected {n_builds} builds of {kernel} in the SASS, "
                 f"found {len(found)}")
        emulated = [fn for fn, ops in found.items()
                    if re.search(must, fn) and not ops["VIADDMNMX"]]
        if emulated:
            fail(f"no DPX add-max (VIADDMNMX) in {emulated}: emulated")
        log(f"[build] DPX add-max (VIADDMNMX) found in every build of "
            f"{kernel} matching {must!r}")
    return peak_ops


@functools.lru_cache(maxsize=None)
def sass_of(lib: Path) -> str:
    """The library's SASS (cuobjdump -sass), disassembled once."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "cuobjdump")
    if not cuobjdump.exists():
        fail(f"{cuobjdump} not found: cannot check the SASS for DPX")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass exited {proc.returncode}: {proc.stderr[-500:]}")
    return proc.stdout


def dpx_in_sass(lib: Path, kernel: str) -> dict:
    """Per instance of ``kernel`` in the library's SASS, the count of each
    DPX opcode."""
    found, fn = {}, None
    for line in sass_of(lib).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                found[fn] = dict.fromkeys(DPX_OPCODES, 0)
            continue
        if fn:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          line)
            if m and m.group(1) in found[fn]:
                found[fn][m.group(1)] += 1
    return found


# ---- phase 2 ----------------------------------------------------------------


def make_problems(seed: int, P: int, bucket: int, sort_m: bool = False,
                  band: int = BAND):
    """Read windows with noisy copies at random band offsets, like the
    pipeline's candidate windows; rows beyond each window length m and
    interior N bases are sentinel 4. Returns (qT, tT, m) as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(P, bucket), dtype=np.int8)
    m = rng.integers(bucket // 4, bucket + 1, size=P)
    if sort_m:
        m = np.sort(m)
    copy = q.copy()
    flips = rng.random(q.shape) < 0.1
    copy[flips] = rng.integers(0, 4, size=int(flips.sum()), dtype=np.int8)
    t = np.full((P, bucket + band), 4, dtype=np.int8)
    off = rng.integers(0, band, size=P)
    cols = off[:, None] + np.arange(bucket)[None, :]
    np.put_along_axis(t, cols, copy, axis=1)
    q[np.arange(bucket)[None, :] >= m[:, None]] = 4
    q[rng.random(q.shape) < 0.01] = 4
    # Edge cases: an empty read, an empty target, a problem scoring 0.
    q[0] = 4
    t[1] = 4
    q[2] = 0
    t[2] = 1
    return q.T.copy(), t.T.copy(), m


def cuda_time_ms(fn, reps: int, warm: bool = False) -> float:
    """Mean ms of ``fn`` over ``reps`` calls (CUDA events), after one
    warm-up call unless ``warm`` says the same call just ran (a plain
    version, run at these shapes by the comparison before its timing)."""
    import torch

    if not warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(cells: float, ops_per_cell: int, n_bytes: float, peak_ops: float):
    """The least time for the work: the larger of operations over the int32
    peak and bytes over the memory rate; and which of the two it is."""
    ops_ms = cells * ops_per_cell / peak_ops * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_kernel(peak_ops: float):
    import torch

    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.kernels import band_dp_v3 as v3

    dev = torch.device("cuda:0")
    params = DPParams()
    max_err = 0
    rev_err = 0
    n_cases = 0

    def end_clamped(qT, tT, qe, te, bucket, band):
        rows = torch.arange(bucket, device=dev)[:, None]
        trows = torch.arange(bucket + band, device=dev)[:, None]
        return (torch.where(rows <= qe[None], qT, 4).to(torch.int8),
                torch.where(trows <= te[None], tT, 4).to(torch.int8))

    def compare(what, got, ref):
        nonlocal max_err, n_cases
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        n_cases += 1
        if err != 0:
            fail(f"kernel disagrees with the plain version: {what} "
                 f"(max abs err {err})")
        return err

    def fwd_case(tag, qT, tT, bucket, n_valid, band=BAND, p=params):
        got = v3.band_dp_v3_fwd(qT, tT, bucket, band, p, n_valid)
        ref = v3.band_dp_v3_fwd_ref(qT, tT, bucket, band, p, n_valid)
        compare(f"fwd {tag}", got, ref)
        return got

    def rev_cases(tag, qT, tT, qe, te, bucket, band=BAND, p=params):
        """The reverse kernel (K1') against its plain version (flip + roll +
        the plain forward pass): on raw windows with the derived m and
        n_valid < P, and on the end-clamped windows the pipeline gives it,
        with m = qe + 1 and with the derived m. Returns the clamped windows
        and m."""
        nonlocal rev_err
        got = v3.band_dp_v3_rev(qT, tT, bucket, band, p, n_valid=200)
        ref = v3.band_dp_v3_rev_ref(qT, tT, bucket, band, p, n_valid=200)
        rev_err = max(rev_err, compare(f"rev raw windows {tag}", got, ref))
        qT2, tT2 = end_clamped(qT, tT, qe, te, bucket, band)
        m = (qe + 1).to(torch.int32)
        ref = v3.band_dp_v3_rev_ref(qT2, tT2, bucket, band, p)
        for how, m_arg in (("m = qe + 1", m), ("derived m", None)):
            got = v3.band_dp_v3_rev(qT2, tT2, bucket, band, p, m=m_arg)
            rev_err = max(rev_err, compare(
                f"rev end-clamped, {how}, {tag}", got, ref))
        return qT2, tT2, m

    # Every bucket at band 128 (the pipeline's), and bucket 2048 at band
    # 256, the kernel's other build.
    cases = [(bucket, BAND) for bucket in AlignConfig().buckets]
    cases.append((2048, 256))
    for bucket, band in cases:
        P = 256
        qT, tT, m = make_problems(bucket, P, bucket, sort_m=True, band=band)
        qT, tT = torch.from_numpy(qT).to(dev), torch.from_numpy(tT).to(dev)
        bounds = m.reshape(-1, 128).max(axis=1)
        t0 = time.perf_counter()
        tag = f"bucket={bucket} band={band}"
        fwd_case(f"{tag} unbounded", qT, tT, bucket, None, band)
        nvb = torch.tensor(np.concatenate([[P - 37], bounds]),
                           dtype=torch.int32, device=dev)
        fwd_case(f"{tag} bounds n_valid={P - 37}", qT, tT, bucket, nvb, band)
        got = v3.band_dp_v3(qT, tT, bucket, band, params)
        ref = v3.band_dp_v3(qT, tT, bucket, band, params,
                            fwd=v3.band_dp_v3_fwd_ref)
        for key in got:
            compare(f"two-pass {key} {tag}", got[key], ref[key])
        compare(f"score_rev == score {tag}", got["score_rev"], got["score"])
        rev_cases(tag, qT, tT, got["qe"], got["te"], bucket, band)
        log(f"[kernel] bucket {bucket:5d} band {band} P {P}: fwd, bounded "
            f"fwd, rev kernel, two-pass exact ({time.perf_counter() - t0:.1f} "
            f"s)")

    # The wide build: match x bucket >= 2^16 (match 3 at bucket 30720), and
    # a mismatch outside int8 at band 256.
    for bucket, band, wide in ((30720, BAND, DPParams(match=3)),
                               (2048, 256, DPParams(mismatch=-200))):
        P = 256
        qT, tT, m = make_problems(bucket + 3, P, bucket, sort_m=True,
                                  band=band)
        qT, tT = torch.from_numpy(qT).to(dev), torch.from_numpy(tT).to(dev)
        nvb = torch.tensor(np.concatenate([[P - 37],
                                           m.reshape(-1, 128).max(axis=1)]),
                           dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        tag = (f"wide match={wide.match} mismatch={wide.mismatch} "
               f"bucket={bucket} band={band}")
        out = fwd_case(f"{tag} unbounded", qT, tT, bucket, None, band, wide)
        fwd_case(f"{tag} bounds", qT, tT, bucket, nvb, band, wide)
        rev_cases(tag, qT, tT, out[:, 1], out[:, 2], bucket, band, wide)
        log(f"[kernel] wide build, match {wide.match} mismatch "
            f"{wide.mismatch}, bucket {bucket:5d} band {band} P {P}: fwd, "
            f"bounded fwd, rev kernel exact ({time.perf_counter() - t0:.1f} s)")

    # Positive scores at bucket 2048: a mismatch of 100 (scores pass 2^16
    # though match x bucket does not, so the wide build must run), open +
    # extend 1 and extend 1. A sentinel row can then change H, so the
    # reverse kernel runs every row (m = bucket) whatever m it is given.
    for pos in (DPParams(mismatch=100), DPParams(gap_open=3, gap_extend=-2),
                DPParams(gap_extend=1)):
        for band in (BAND, 256):
            qT, tT, _ = make_problems(2051, 256, 2048, sort_m=True, band=band)
            qT, tT = torch.from_numpy(qT).to(dev), torch.from_numpy(tT).to(dev)
            tag = f"{pos} bucket=2048 band={band}"
            out = fwd_case(tag, qT, tT, 2048, None, band, pos)
            rev_cases(tag, qT, tT, out[:, 1], out[:, 2], 2048, band, pos)
            log(f"[kernel] {pos}, bucket 2048 band {band} P 256: fwd and rev "
                f"kernel exact (best score {int(out[:, 0].max())})")

    # Production-shaped batch: P = 32768 at bucket 2048, m-sorted windows.
    P, bucket = 32768, 2048
    qT, tT, m = make_problems(7, P, bucket, sort_m=True)
    qT, tT = torch.from_numpy(qT).to(dev), torch.from_numpy(tT).to(dev)
    bounds = m.reshape(-1, 128).max(axis=1)
    nvb = torch.tensor(np.concatenate([[P - 100], bounds]), dtype=torch.int32,
                       device=dev)
    fwd_case("P=32768 bucket=2048 unbounded", qT, tT, bucket, None)
    fwd_case("P=32768 bucket=2048 bounds", qT, tT, bucket, nvb)
    got = v3.band_dp_v3(qT, tT, bucket, BAND, params)
    ref2 = v3.band_dp_v3(qT, tT, bucket, BAND, params,
                         fwd=v3.band_dp_v3_fwd_ref)
    for key in got:
        compare(f"two-pass {key} P=32768", got[key], ref2[key])
    qT2, tT2, m2 = rev_cases("P=32768 bucket=2048", qT, tT, got["qe"],
                             got["te"], bucket)
    log(f"[kernel] P 32768 bucket 2048: fwd, bounded fwd, rev kernel, "
        f"two-pass exact; {n_cases} comparisons, max abs err {max_err}")

    # Times at the production shape.
    ms = cuda_time_ms(
        lambda: v3.band_dp_v3_fwd(qT, tT, bucket, BAND, params, nvb), reps=20
    )
    plain_ms = cuda_time_ms(
        lambda: v3.band_dp_v3_fwd_ref(qT, tT, bucket, BAND, params, nvb),
        reps=2, warm=True,
    )
    n = P - 100
    rows = np.repeat(np.minimum((bounds + 7) // 8 * 8, bucket), 128)[:n]
    need = np.minimum(m[:n], rows)
    cells = float(need.sum()) * BAND
    n_bytes = float(need.sum() + (need + BAND).sum()) + 4 * (1 + len(bounds)) \
        + 12 * P
    bms, bound_by = bound_ms(cells, OPS_PER_CELL["k1"], n_bytes, peak_ops)
    run_cells = float(rows.sum()) * BAND
    log(f"[kernel] band_dp_v3_fwd P 32768 bucket 2048 (row bounds): kernel "
        f"{ms:.3f} ms ({run_cells / ms / 1e6:.2f} Gcell/s of rows run, "
        f"{cells / ms / 1e6:.2f} Gcell/s of rows needed), plain "
        f"{plain_ms:.3f} ms; bound {bms:.3f} ms by "
        f"{bound_by} ({cells / 1e9:.3f} Gcell x {OPS_PER_CELL['k1']} ops), "
        f"{100 * bms / ms:.1f}% of bound")

    # K1': the reverse kernel alone on the batch's end-clamped windows
    # (m = qe + 1), which need qe + 1 rows each; beside it the reverse pass
    # it replaced (flip + roll, then the forward kernel on all rows).
    rev_ms = cuda_time_ms(
        lambda: v3.band_dp_v3_rev(qT2, tT2, bucket, BAND, params, m=m2),
        reps=20)
    flip_ms = cuda_time_ms(
        lambda: v3.band_dp_v3_rev_ref(qT2, tT2, bucket, BAND, params,
                                      fwd=v3.band_dp_v3_fwd), reps=10)
    rev_plain_ms = cuda_time_ms(
        lambda: v3.band_dp_v3_rev_ref(qT2, tT2, bucket, BAND, params), reps=1,
        warm=True)
    rev_need = m2.cpu().numpy().astype(np.int64).clip(min=0)
    rev_cells = float(rev_need.sum()) * BAND
    rev_bytes = float(rev_need.sum() + (rev_need + BAND).sum()) + 16 * P
    rev_bms, rev_by = bound_ms(rev_cells, OPS_PER_CELL["k1"], rev_bytes,
                               peak_ops)
    log(f"[kernel] band_dp_v3_rev P 32768 bucket 2048 (reverse kernel, m = "
        f"qe + 1): {rev_ms:.3f} ms ({rev_cells / rev_ms / 1e6:.2f} Gcell/s), "
        f"plain {rev_plain_ms:.3f} ms, flip + roll + forward kernel "
        f"{flip_ms:.3f} ms; bound {rev_bms:.3f} ms by {rev_by} "
        f"({rev_cells / 1e9:.3f} Gcell x {OPS_PER_CELL['k1']} ops), "
        f"{100 * rev_bms / rev_ms:.1f}% of bound")
    return {
        "fwd": {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": bound_by},
        "rev": {"max_abs_err": rev_err, "ms": rev_ms, "plain_ms": rev_plain_ms,
                "bound_ms": rev_bms, "bound_by": rev_by},
    }


# ---- phase 3 ----------------------------------------------------------------


def simulate_bundle(out: Path, mb: int, n_svs: int, cov: float):
    """The scale configuration of bench.py: seeds 2 (genome) and 11 (reads)."""
    from svjedi_tpu_torch.io import sim
    from svjedi_tpu_torch.io.fasta import write_fasta

    t0 = time.perf_counter()
    s = sim.simulate(
        seed=2, chrom_lengths={"chr1": mb * 1_000_000}, n_svs=n_svs,
        sv_types=("DEL", "INS", "INV"),
    )
    paths = {"vcf": out / "truth.vcf", "ref": out / "ref.fasta",
             "reads": out / "reads.fastq"}
    sim.write_truth_vcf(s, paths["vcf"])
    write_fasta(paths["ref"], s.chroms)
    n_reads, n_bases = sim.simulate_reads_fastq(
        np.random.default_rng(11), s.haplotypes, coverage=cov,
        path=paths["reads"],
    )
    log(f"[main] simulated {mb} Mb, {len(s.svs)} SVs, {cov}x: {n_reads} "
        f"reads, {n_bases / 1e6:.1f} Mb of reads "
        f"({time.perf_counter() - t0:.1f} s)")
    return paths, n_reads


def check_native(counters, what: str) -> None:
    """The run's host library (the file its loader opened) must be the
    port's own build."""
    from svjedi_tpu_torch.kernels import build

    loaded = counters.get("native_lib")
    if loaded is None or os.path.realpath(loaded) != os.path.realpath(
            build.NATIVE_LIB):
        fail(f"{what} loaded native library {counters.get('native_lib')!r}, "
             f"not the port's build {build.NATIVE_LIB}")


def expected_chunks(n_reads: int, chunk_reads: int = 16384) -> int:
    """Chunks ``align_and_count`` cuts ``n_reads`` into at its defaults: a
    quarter chunk first when there is more than one chunk."""
    if n_reads <= chunk_reads:
        return 1
    first = max(256, chunk_reads // 4)
    return 1 + -(-(n_reads - first) // chunk_reads)


def check_device_scan(counters, n_reads: int, what: str) -> int:
    """The run must have seeded from the device scan, one kernel launch per
    chunk; returns the launches."""
    launches = int(counters.get("dev_scan_launches", -1))
    if counters.get("seed_path") != "device":
        fail(f"{what} recorded seed_path {counters.get('seed_path')!r}, not "
             f"'device'")
    if launches != expected_chunks(n_reads):
        fail(f"{what} launched the dev_scan kernel {launches} times for "
             f"{expected_chunks(n_reads)} chunks")
    return launches


def check_stats_launches(counters, what: str) -> int:
    """The run's audit must have gone through the stats kernel (A1), whose
    fused-fetch entry fetches every piece from the chunk's buffers; returns
    its launches."""
    launches = int(counters.get("band_dp_stats_launches", 0))
    if launches <= 0:
        fail(f"{what} launched the band_dp_stats kernel no time")
    if not counters.get("audit_pieces"):
        fail(f"{what}: the audit handed A1 no piece")
    return launches


def audit_split(counters, launches: int) -> str:
    return (f"audit: band_dp_stats launches {launches}, pieces "
            f"{counters.get('audit_pieces')}, piece offsets' upload "
            f"{counters.get('audit_assembly_s')} s, stats DP to host "
            f"{counters.get('audit_dp_s')} s")


def phase_main_path(out: Path, paths, n_reads, timeout: int = 900):
    from svjedi_tpu_torch.evals.contingency import contingency_report
    from svjedi_tpu_torch.kernels import band_dp_v3

    prefix = out / "run"
    cmd = [
        sys.executable, "-m", "svjedi_tpu_torch", "run",
        "-v", str(paths["vcf"]), "-r", str(paths["ref"]),
        "-q", str(paths["reads"]), "-p", str(prefix), "--gaf",
    ]
    band_dp_v3.launches = 0  # the run is a subprocess: its count is its own
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-15:]:
        log(f"[main] stderr: {line}")
    if proc.returncode != 0:
        fail(f"svjedi_tpu_torch run exited {proc.returncode}")
    faults = [w for w in FAULT_WARNINGS if w in proc.stderr]
    if faults:
        fail(f"fault warnings on stderr: {faults}")
    n_audit_warn = proc.stderr.count(AUDIT_WARNING)
    with open(f"{prefix}_stats.json") as fh:
        stats = json.load(fh)
    counters, timings = stats["counters"], stats["timings_s"]
    launches = int(counters.get("band_dp_v3_launches", 0))
    rev_launches = int(counters.get("band_dp_v3_rev_launches", 0))
    if launches - rev_launches <= 0:
        fail("the main path launched the band_dp_v3 forward kernel no time")
    if rev_launches <= 0:
        fail("the main path launched the band_dp_v3 reverse kernel no time")
    check_native(counters, "the main path")
    scan_launches = check_device_scan(counters, n_reads, "the main path")
    stats_launches = check_stats_launches(counters, "the main path")
    report = contingency_report(paths["vcf"], f"{prefix}_genotype.vcf")
    acc = re.search(r"accuracy: ([\d.]+)", report)
    log("[main] " + " | ".join(report.strip().splitlines()))
    if acc is None or float(acc.group(1)) != 100.0:
        fail("genotyping accuracy is not 100.0")
    align_s = float(timings["align"])
    log(f"[main] run wall {wall:.1f} s; align stage {align_s:.2f} s, "
        f"{n_reads / align_s:.1f} reads/s; stages "
        + ", ".join(f"{k} {v:.1f}s" for k, v in timings.items()))
    log(f"[main] device {counters.get('device_name')}; "
        f"max_memory_allocated {counters.get('device_max_memory_allocated')} "
        f"bytes; band_dp_v3 launches {launches} (reverse kernel "
        f"{rev_launches}); seed path "
        f"{counters.get('seed_path')} (dev_scan launches {scan_launches}); "
        f"audit re-score warnings {n_audit_warn}; "
        f"n_audit_rescore_below {counters.get('n_audit_rescore_below')}; "
        + audit_split(counters, stats_launches))
    return launches, rev_launches, scan_launches, stats_launches, prefix


# ---- phase 2b -----------------------------------------------------------------


def make_dma_problems(seed: int, P: int, bucket: int, dev, band: int = BAND):
    """One read per problem, a 10%-noisy copy of a stretch of one of 8
    random panel paths (reverse-complemented for odd problems, so their
    windows lie in the rc half of reads2), uploaded with the port's
    ``upload``. Stretches may run off either path end (windows crossing
    t_lo/t_hi); windows have m in [bucket/4, bucket], sorted, and the last
    16 problems are padding rows with m = 0. Returns (data, vecs) with the
    five (P,) int32 CUDA vectors in band_dp_dma_raw's order."""
    from types import SimpleNamespace

    import torch

    from svjedi_tpu_torch.align.device import upload

    rng = np.random.default_rng(seed)
    n_paths, path_len = 8, max(4 * bucket, 20_000)
    seqs = rng.integers(0, 4, size=(n_paths, path_len), dtype=np.int8)
    panel = SimpleNamespace(paths=[SimpleNamespace(seq=s, length=path_len)
                                   for s in seqs])
    pi = rng.integers(0, n_paths, P)
    pos = rng.integers(-bucket // 4, path_len - 3 * bucket // 4, P)
    idx = pos[:, None] + np.arange(bucket)[None, :]
    inside = (idx >= 0) & (idx < path_len)
    reads = np.where(inside, seqs[pi[:, None], idx.clip(0, path_len - 1)],
                     rng.integers(0, 4, size=idx.shape, dtype=np.int8))
    flips = rng.random(reads.shape) < 0.1
    reads[flips] = rng.integers(0, 4, size=int(flips.sum()), dtype=np.int8)
    rev = np.arange(P) % 2 == 1
    reads[rev] = np.where(reads[rev] < 4, 3 - reads[rev], reads[rev])[:, ::-1]
    data = upload(reads.reshape(-1), panel, dev)
    N = data.n_bases
    read_off = np.arange(P, dtype=np.int64) * bucket
    q_start = np.where(rev, N + (N - (read_off + bucket)), read_off)
    m = np.sort(rng.integers(bucket // 4, bucket + 1, P))
    m[-16:] = 0
    path_start = data.panel_start[pi]
    t_start = path_start + pos - band // 2 + rng.integers(-16, 17, P)
    t_lo = path_start
    t_hi = path_start + path_len
    vecs = tuple(torch.from_numpy(v.astype(np.int32)).to(dev)
                 for v in (q_start, t_start, m, t_lo, t_hi))
    return data, vecs


def phase_onepass_kernels(peak_ops: float):
    """K4 (pre-gathered) and K3 (fused fetch) against their plain versions."""
    import torch

    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.kernels import band_dp as k4
    from svjedi_tpu_torch.kernels import band_dp_dma as k3

    dev = torch.device("cuda:0")
    params = DPParams()
    oe0 = DPParams(gap_open=2, gap_extend=-2)  # open + extend = 0
    wide = DPParams(mismatch=-200)
    pos = DPParams(mismatch=100)  # scores past 2^16: the wide build
    err = {"k3": 0, "k4": 0}
    n_cases = 0

    def compare(which, what, got, ref):
        nonlocal n_cases
        torch.cuda.synchronize()
        e = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        err[which] = max(err[which], e)
        n_cases += 1
        if e != 0:
            fail(f"{which} kernel disagrees with the plain version: {what} "
                 f"(max abs err {e})")

    def k4_case(tag, q, t, band=BAND, p=params):
        got = k4.band_dp_onepass(q, t, band, p)
        ref = k4.band_dp_onepass_ref(q, t, band, p)
        for key in got:
            compare("k4", f"{key} {tag}", got[key], ref[key])

    def k3_case(tag, data, vecs, bucket, band=BAND, p=params):
        got = k3.band_dp_dma_raw(data.reads2, data.panel_padded, *vecs,
                                 bucket=bucket, band=band, params=p)
        ref = k3.band_dp_dma_raw_ref(data.reads2, data.panel_padded, *vecs,
                                     bucket=bucket, band=band, params=p)
        compare("k3", tag, got, ref)
        return got

    # Every bucket at band 128 (the pipeline's), and one at band 256, the
    # kernels' other build.
    cases = [(bucket, BAND) for bucket in AlignConfig().buckets]
    cases.append((2048, 256))
    for bucket, band in cases:
        t0 = time.perf_counter()
        qT, tT, _ = make_problems(bucket, 256, bucket, sort_m=True, band=band)
        q = torch.from_numpy(qT.T.copy()).to(dev)
        t = torch.from_numpy(tT.T.copy()).to(dev)
        k4_case(f"bucket={bucket} band={band}", q, t, band)
        data, vecs = make_dma_problems(bucket + 1, 256, bucket, dev, band)
        k3_case(f"bucket={bucket} band={band}", data, vecs, bucket, band)
        extra = ""
        if bucket == 2048:
            # A zero gap open (every row runs), both wide builds (a
            # mismatch outside int8; a positive mismatch whose scores pass
            # 2^16), and in each warp m = 0 beside m = bucket (K3) or an
            # all-sentinel read row beside a full one (K4).
            for p in (oe0, wide, pos):
                tag = f"{p} bucket={bucket} band={band}"
                k3_case(tag, data, vecs, bucket, band, p)
                k4_case(tag, q, t, band, p)
            # K4's row scan byte by byte: rows of 2056 bytes (a multiple
            # of 8, not of 16), and q at an 8-byte storage offset.
            q8T, t8T, _ = make_problems(bucket + 2, 256, bucket + 8,
                                        sort_m=True, band=band)
            q8 = torch.from_numpy(q8T.T.copy()).to(dev)
            q8[0::2] = 4
            k4_case(f"M={bucket + 8} band={band}", q8,
                    torch.from_numpy(t8T.T.copy()).to(dev), band)
            q_off = torch.empty(q.numel() + 8, dtype=torch.int8,
                                device=dev)[8:].view(q.shape)
            q_off.copy_(q)
            k4_case(f"q at an 8-byte offset, band={band}", q_off, t, band)
            q_start, t_start, m, t_lo, t_hi = vecs
            even = torch.arange(len(m), device=dev) % 2 == 0
            alt = torch.where(even, 0, bucket).to(torch.int32)
            short_full = (q_start, t_start, alt, t_lo, t_hi)
            q_alt = torch.where(even[:, None], 4,
                                torch.where(q == 4, 0, q)).to(torch.int8)
            for p in (params, oe0, wide):
                k3_case(f"m 0 beside m {bucket}, {p}, band={band}", data,
                        short_full, bucket, band, p)
                k4_case(f"all-sentinel row beside a full row, {p}, "
                        f"band={band}", q_alt, t, band, p)
            extra = ("; both with a zero gap open, in both wide builds and "
                     "with an empty problem beside a full one, K4's byte "
                     "row scan exact")
        del data, vecs
        log(f"[onepass] bucket {bucket:5d} band {band} P 256: band_dp_onepass "
            f"and band_dp_dma exact{extra} ({time.perf_counter() - t0:.1f} s)")

    P, bucket = 32768, 2048
    qT, tT, _ = make_problems(7, P, bucket, sort_m=True)
    q = torch.from_numpy(qT.T.copy()).to(dev)
    t = torch.from_numpy(tT.T.copy()).to(dev)
    k4_case("P=32768 bucket=2048", q, t)
    data, vecs = make_dma_problems(8, P, bucket, dev)
    dma_out = k3_case("P=32768 bucket=2048", data, vecs, bucket)
    log(f"[onepass] P 32768 bucket 2048: both exact; {n_cases} comparisons, "
        f"max abs err K4 {err['k4']}, K3 {err['k3']}")

    times = {}
    for name, kern, plain in (
        ("k4", lambda: k4.band_dp_onepass(q, t, BAND, params),
         lambda: k4.band_dp_onepass_ref(q, t, BAND, params)),
        ("k3", lambda: k3.band_dp_dma_raw(data.reads2, data.panel_padded,
                                          *vecs, bucket=bucket, band=BAND,
                                          params=params),
         lambda: k3.band_dp_dma_raw_ref(data.reads2, data.panel_padded, *vecs,
                                        bucket=bucket, band=BAND,
                                        params=params)),
    ):
        ms = cuda_time_ms(kern, reps=10)
        plain_ms = cuda_time_ms(plain, reps=1, warm=True)
        times[name] = (ms, plain_ms)
    # Bounds: the rows each problem needs (K3's m; K4's rows up to its last
    # read code other than the sentinel), each input byte once, 32 bytes
    # out each.
    k3_m = np.minimum(vecs[2].cpu().numpy().astype(np.int64), bucket)
    coded = qT[::-1] != 4
    k4_rows = np.where(coded.any(axis=0), bucket - coded.argmax(axis=0), 0)
    need = {"k4": k4_rows.astype(np.int64), "k3": k3_m}
    bounds = {}
    for name in ("k4", "k3"):
        ms, plain_ms = times[name]
        cells = float(need[name].sum()) * BAND
        n_bytes = float(need[name].sum() + (need[name] + BAND).sum()) \
            + 32 * P + (20 * P if name == "k3" else 0)
        bms, by = bound_ms(cells, OPS_PER_CELL["onepass"], n_bytes, peak_ops)
        bounds[name] = (bms, by)
        log(f"[onepass] {name.upper()} P 32768 bucket 2048: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms; bound {bms:.3f} ms by {by} "
            f"({cells / 1e9:.3f} Gcell x {OPS_PER_CELL['onepass']} ops), "
            f"{100 * bms / ms:.1f}% of bound")
    return err, times, bounds, (data, vecs, dma_out, bucket)


# ---- phase 2d -----------------------------------------------------------------

#: int32 operations per k-mer position of the device scan (D1) in the
#: run-length formulation (the JAX program's): rolling the two 2-bit k-mers
#: over one new base (code & 3, 3 - c, shift | or & mask for fwd, shift,
#: shift, or for rc, the N test and its last-N update: 10), then min,
#: fwd != rc, fmix32 (3 shifts, 3 xors, 2 multiplies), the read-id tests
#: and the two selects (15).
SCAN_OPS_PER_POSITION = 25
#: Per step of a run (read-id compare, hash compare, count); a valid
#: position takes min(a + 1, w - 1) + min(b + 1, w - 1) steps.
SCAN_OPS_PER_STEP = 3
#: Per position in the sliding-window formulation the kernel runs
#: (csrc/dev_scan.cu), which takes no run steps: the two k-mers from funnel
#: shifts (2 funnel shifts, a shift, a mask: 4), the N and read-boundary
#: tests on bit words (5 each), the read-range tests (3), fwd != rc, min,
#: fmix32 (8), the select of INVALID (1: 28), then the window minimum: a
#: prefix and a suffix compare-select (4), the window's compare-select (2)
#: and its three validity compares (3). The bound takes the fewer of the
#: two formulations' counts on the run's data.
SCAN_OPS_WINDOW_PER_POSITION = 37
SCAN_KW = ((15, 10), (11, 5))


def scan_read_sets(k: int, w: int):
    """Edge-case reads for the scan: lengths 5, k - 1, k, k + 1, k + w - 2,
    k + w - 1 and longer, an empty read, N runs, an all-N read, all-
    palindromic and periodic reads; and reads against tile edges (the
    first design's 1024-position tiles: one read ending on 1024, one
    straddling 2048, an empty one, 3,097 codes in all, not a multiple of 8;
    and the kernel's 4096-position tiles, below)."""
    def concat(reads):
        return (np.concatenate(reads),
                np.concatenate([[0], np.cumsum([len(r) for r in reads])]))

    rng = np.random.default_rng(11)
    reads = [rng.integers(0, 4, n).astype(np.int8)
             for n in (5, k - 1, k, k + 1, k + w - 2, k + w - 1, 200, 1999,
                       7777)]
    nread = rng.integers(0, 4, 500).astype(np.int8)
    nread[:25] = 4
    nread[200:260] = 4
    nread[-3:] = 4
    at = np.tile(np.array([0, 3], np.int8), 200)  # "ATAT..."
    acgt = np.tile(np.arange(4, dtype=np.int8), 300)
    reads += [nread, np.full(60, 4, np.int8), at, acgt]
    reads.insert(3, np.zeros(0, np.int8))
    tiles = [rng.integers(0, 4, n).astype(np.int8)
             for n in (1024, 1000, 0, 1, 1030, 37, 5)]
    # Against the kernel's 4096-position tiles: reads ending on 2048 and on
    # the tile edge at 4096, an empty one between, 4,133 codes in all.
    tiles2 = [rng.integers(0, 4, n).astype(np.int8)
              for n in (2048, 1000, 0, 1048, 30, 7)]
    return {"edge reads": concat(reads), "tile edges": concat(tiles),
            "4096 tile edges": concat(tiles2)}


def build_genome(paths):
    """The 10 Mb bundle's panel, panel index and decoy, as align_and_count
    builds them (AlignConfig defaults)."""
    from svjedi_tpu_torch.align.decoy import build_decoy
    from svjedi_tpu_torch.align.index import build_panel_index
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.cluster import build_panel
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
    from svjedi_tpu_torch.io.fasta import read_fasta

    cfg = AlignConfig()
    t0 = time.perf_counter()
    chroms = read_fasta(paths["ref"])
    parsed = parse_vcf_svs(paths["vcf"], {c: len(s) for c, s in chroms.items()})
    panel = build_panel(build_graph(chroms, parsed), flank=cfg.flank,
                        cluster_gap=cfg.cluster_gap,
                        max_paths_per_cluster=cfg.max_paths_per_cluster,
                        max_hops_per_path=cfg.max_hops_per_path)
    hits = cfg.max_hits_per_minimizer
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window,
                              max_hits_per_minimizer=hits)
    decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                        max_hits_per_minimizer=hits)
    log(f"[genome] panel ({len(panel.paths)} paths), index and decoy of the "
        f"10 Mb bundle ({time.perf_counter() - t0:.1f} s)")
    return {"panel": panel, "index": index, "decoy": decoy}


def phase_dev_scan(peak_ops: float, paths, genome):
    """D1: the scan kernel against its plain version on the card, bit for
    bit, on edge cases and on a full production chunk of the 10 Mb reads;
    there also against the native host emission and, through
    seed_candidates, the host path's candidates. Times the kernel."""
    from types import SimpleNamespace

    import torch

    from svjedi_tpu_torch.align import dev_scan as scan
    from svjedi_tpu_torch.align.device import upload
    from svjedi_tpu_torch.align.index import merge_indexes
    from svjedi_tpu_torch.align.seed import ChainParams, seed_candidates
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.io.fastq import read_reads
    from svjedi_tpu_torch.kernels import dev_scan as kscan
    from svjedi_tpu_torch.utils.native import load_native

    dev = torch.device("cuda:0")
    no_panel = SimpleNamespace(paths=[])
    n_cases = 0

    def check(tag, dd, k, w):
        nonlocal n_cases
        n_cap = scan._scan_cap(dd.n_codes, dd.n_bases)
        got = kscan.dev_scan(dd.reads2, dd.offsets32, k, w, n_cap)
        ref = kscan.dev_scan_ref(dd.reads2, dd.offsets32, k, w, n_cap)
        pinned = scan.fetch_bitmask(scan.dispatch_scan(dd, k, w))
        torch.cuda.synchronize()
        n_cases += 1
        if not torch.equal(got, ref):
            n_bad = int((got != ref).sum())
            fail(f"dev_scan kernel differs from its plain version: {tag}, "
                 f"k={k} w={w}, {n_bad} of {got.numel()} bytes")
        if not np.array_equal(pinned, got.cpu().numpy()):
            fail(f"dispatch_scan's pinned copy differs from the kernel's "
                 f"bitmask: {tag}, k={k} w={w}")
        return got.cpu().numpy(), n_cap

    for k, w in SCAN_KW:
        for tag, (codes, offsets) in scan_read_sets(k, w).items():
            dd = upload(codes, no_panel, dev, offsets=offsets)
            bits, n_cap = check(tag, dd, k, w)
            rid, _ = scan.bitmask_positions(bits, offsets)
            n_kmers = np.diff(offsets) - k + 1
            if np.isin(rid, np.flatnonzero(n_kmers < w)).any():
                fail(f"dev_scan set a bit in a read shorter than k + w - 1 "
                     f"({tag}, k={k} w={w})")
            log(f"[scan] {tag}, k {k} w {w}: n_codes {len(codes)}, n_cap "
                f"{n_cap}, {len(rid)} minimizers; kernel, plain version and "
                f"pinned copy bit-equal")

    # A full production chunk (chunk_reads = 16,384; the first chunk of a
    # run is a quarter chunk, so this is the run's second).
    cfg = AlignConfig()
    k, w = cfg.kmer, cfg.window
    t0 = time.perf_counter()
    reads = read_reads(str(paths["reads"]))
    chunk = reads.slice(4096, min(reads.n_reads, 4096 + 16384))
    del reads
    dd = upload(chunk.codes, no_panel, dev, offsets=chunk.offsets)
    bits, n_cap = check("production chunk", dd, k, w)
    native = load_native()
    if native is None:
        fail("the port's native library did not load")
    m_read, m_pos, _, _ = native.minimizers(chunk.codes, chunk.offsets, k, w,
                                            n_threads=os.cpu_count() or 1)
    keep = (np.diff(chunk.offsets) - k + 1)[m_read] >= w
    got_read, got_pos = scan.bitmask_positions(bits, chunk.offsets)
    if not (np.array_equal(got_read, m_read[keep])
            and np.array_equal(got_pos, m_pos[keep])):
        fail(f"dev_scan's emission differs from the native host scan: "
             f"{len(got_read)} against {int(keep.sum())} minimizers")
    log(f"[scan] production chunk: {chunk.n_reads} reads, n_codes "
        f"{len(chunk.codes)}, n_cap {n_cap}: kernel == plain version, set "
        f"bits == native emission ({len(got_read)} minimizers) "
        f"({time.perf_counter() - t0:.1f} s)")

    # Candidates from the bitmask == the host scan's, on the merged panel +
    # decoy index with the panel-path limit (align_and_count's seeding).
    t0 = time.perf_counter()
    index = genome["index"]
    combo = merge_indexes(index, genome["decoy"].index)
    cp = ChainParams(min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
                     max_gap=cfg.chain_max_gap, drift_abs=cfg.chain_drift_abs,
                     drift_permille=cfg.chain_drift_permille,
                     block_rows=cfg.block_rows,
                     ext_min_anchors=cfg.chain_ext_min_anchors)
    limit = len(index.path_len)
    t1 = time.perf_counter()
    via_dev = seed_candidates(chunk, combo, chain_params=cp, threads=cfg.threads,
                              panel_path_limit=limit, bits=bits)
    t2 = time.perf_counter()
    via_host = seed_candidates(chunk, combo, chain_params=cp,
                               threads=cfg.threads, panel_path_limit=limit)
    t3 = time.perf_counter()
    for f in ("read", "path", "strand", "d0", "n_anchors", "chain", "q_lo",
              "q_hi", "a_lo", "a_hi"):
        if not np.array_equal(getattr(via_dev, f), getattr(via_host, f)):
            fail(f"seed_candidates from the bitmask differ from the host "
                 f"scan's in {f}")
    log(f"[scan] production chunk: seed_candidates(bits=) == host scan "
        f"({len(via_host)} candidates; lookup + chain from the bitmask "
        f"{t2 - t1:.2f} s, host scan + lookup + chain {t3 - t2:.2f} s; "
        f"index merge {t1 - t0:.1f} s)")
    del combo, via_dev, via_host

    ms = cuda_time_ms(
        lambda: kscan.dev_scan(dd.reads2, dd.offsets32, k, w, n_cap), reps=20)
    plain_ms = cuda_time_ms(
        lambda: kscan.dev_scan_ref(dd.reads2, dd.offsets32, k, w, n_cap),
        reps=2, warm=True)
    # Bound: the k-mer positions inside the codes, the run steps this
    # chunk's hashes take, each code byte read once, offsets once, the
    # bitmask written once.
    h, _, a, b = kscan.scan_runs(dd.reads2, dd.offsets32, k, w, n_cap)
    valid = h != kscan.INVALID
    steps = int(((a + 1).clamp(max=w - 1) + (b + 1).clamp(max=w - 1))[valid]
                .sum())
    positions = max(0, dd.n_codes - k + 1)
    runs_ops = positions * SCAN_OPS_PER_POSITION + steps * SCAN_OPS_PER_STEP
    window_ops = positions * SCAN_OPS_WINDOW_PER_POSITION
    ops = min(runs_ops, window_ops)
    n_bytes = dd.n_codes + 4 * dd.offsets32.numel() + n_cap // 8
    ops_ms = ops / peak_ops * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                                  "bytes")
    log(f"[scan] dev_scan production chunk (n_cap {n_cap}, {positions} "
        f"positions, {steps} run steps): kernel {ms:.3f} ms "
        f"({positions / ms / 1e6:.2f} Gpos/s), plain {plain_ms:.3f} ms; bound "
        f"{bms:.3f} ms by {by} ({ops / 1e9:.3f} Gop, the fewer of run-length "
        f"{runs_ops / 1e9:.3f} and sliding-window {window_ops / 1e9:.3f}; "
        f"bytes {bytes_ms:.3f} ms), {100 * bms / ms:.1f}% of bound; "
        f"{n_cases} bit-equal checks")
    del h, a, b, valid, dd
    torch.cuda.empty_cache()
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by}


# ---- phase 2e -----------------------------------------------------------------

#: The audit's buckets (AlignConfig.buckets up to block_rows) and its band,
#: 2 x cfg.band; 512 is the audit's band when cfg.band is 256.
STATS_CASES = ((512, 256), (1024, 256), (2048, 256), (2048, 512))
#: The winner fields compute_winner_stats fills.
AUDIT_FIELDS = ("matches", "blocklen", "rescore_deficit", "rescore_flag")


def make_pieces(seed: int, P: int, M: int, band: int):
    """Audit-like pieces: a read window of m <= M bases (ragged: sentinel
    rows after it; 1% interior N) and a target window holding a 10%-noisy
    copy with indels near the band's centre. Then the edge and tie cases:
    an all-sentinel read row, an all-sentinel target row, poly-A against
    poly-A, di- and trinucleotide repeats, and two equal local alignments,
    the first ending at an earlier row on a higher band offset (the row
    rule reports it, the per-cell rule the second). Returns numpy q, t."""
    rng = np.random.default_rng(seed)
    q = np.full((P, M), 4, dtype=np.int8)
    t = np.full((P, M + band), 4, dtype=np.int8)
    m = rng.integers(M // 4, M + 1, P)
    reads = rng.integers(0, 4, (P, M)).astype(np.int8)
    copy = reads.copy()
    flips = rng.random(copy.shape) < 0.1
    copy[flips] = rng.integers(0, 4, int(flips.sum()))
    for p in range(P):
        c = np.insert(np.delete(copy[p, :m[p]], rng.integers(0, m[p], 3)),
                      rng.integers(0, m[p] - 3, 3),
                      rng.integers(0, 4, 3).astype(np.int8))
        off = band // 2 + int(rng.integers(-20, 21))
        n = min(len(c), M + band - off)
        t[p, off:off + n] = c[:n]
    q[:] = np.where(np.arange(M)[None, :] < m[:, None], reads, 4)
    q[rng.random(q.shape) < 0.01] = 4
    q[0] = 4
    t[1] = 4
    q[2], t[2] = 0, 0
    q[3], t[3] = np.resize([0, 1], M), np.resize([0, 1], M + band)
    q[4], t[4] = np.resize([2, 0, 3], M), np.resize([1, 2, 0, 3], M + band)
    pair = np.random.default_rng(5)
    x, y = (pair.integers(0, 4, 30).astype(np.int8) for _ in range(2))
    q[5], t[5] = 4, 4
    q[5, :30], t[5, band - 28:band + 2] = x, x
    q[5, 40:70], t[5, 60:90] = y, y
    return q, t


def phase_stats_kernel(peak_ops: float, paths, genome):
    """A1: the stats kernel against its plain version on the card, exactly,
    on edge cases and on one production chunk's audit; times it."""
    import torch

    from svjedi_tpu_torch.align import device as tdev
    from svjedi_tpu_torch.align import pipeline as apipe
    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.config import AlignConfig, GenotypeConfig
    from svjedi_tpu_torch.io.fastq import read_reads
    from svjedi_tpu_torch.kernels import band_dp_stats as a1

    dev = torch.device("cuda:0")
    max_err = 0
    n_cases = 0

    def compare(tag, q, t, band, p=DPParams()):
        nonlocal max_err, n_cases
        got = a1.band_dp_stats(q, t, band, p)
        ref = a1.band_dp_stats_ref(q, t, band, p)
        torch.cuda.synchronize()
        for key in a1.STATS_COLS:
            e = int((got[key].to(torch.int64) - ref[key].to(torch.int64))
                    .abs().max())
            max_err = max(max_err, e)
            if e != 0:
                fail(f"the stats kernel disagrees with its plain version: "
                     f"{key}, {tag} (max abs err {e})")
        n_cases += 1
        return ref

    for bucket, band in STATS_CASES:
        t0 = time.perf_counter()
        q, t = make_pieces(bucket + band, 256, bucket, band)
        q, t = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
        tag = f"bucket={bucket} band={band}"
        ref = compare(tag, q, t, band)
        if (int(ref["score"][5]), int(ref["qe"][5]),
                int(ref["te"][5])) != (60, 29, band + 1):
            fail(f"two equal local alignments: the end is not the row rule "
                 f"({tag}: qe {int(ref['qe'][5])}, te {int(ref['te'][5])})")
        extra = ""
        if bucket == 2048:
            # Every row runs (a zero gap open; a positive mismatch) and the
            # wide build (a mismatch outside int8).
            for p in (DPParams(gap_open=2, gap_extend=-2),
                      DPParams(mismatch=1), DPParams(mismatch=-200)):
                compare(f"{p} {tag}", q, t, band, p)
            extra = ("; also with a zero gap open, a positive mismatch and "
                     "in the wide build")
        log(f"[stats] bucket {bucket:5d} band {band} P 256: band_dp_stats "
            f"exact{extra} ({time.perf_counter() - t0:.1f} s)")

    # One production chunk's audit (the run's second chunk, 16,384 reads):
    # its winners, then compute_winner_stats on the card two ways.
    cfg = AlignConfig()
    t0 = time.perf_counter()
    reads = read_reads(str(paths["reads"]))
    chunk = reads.slice(4096, min(reads.n_reads, 4096 + 16384))
    del reads
    _, _, winners = apipe.align_and_count(
        chunk, genome["panel"], genome["index"], cfg, GenotypeConfig(),
        device=dev, collect_audit=False, chunk_reads=16384,
        decoy=genome["decoy"])
    log(f"[stats] production chunk: {chunk.n_reads} reads, "
        f"{len(winners.read)} winners ({time.perf_counter() - t0:.1f} s)")
    flat = {}

    def fused_dp(reads2, panel_padded, cols, bucket, band, params):
        flat[bucket] = cols
        return band_dp_stats_flat(reads2, panel_padded, cols, bucket, band,
                                  params)

    def plain_dp(reads2, panel_padded, cols, bucket, band, params):
        q_start, t_start, m, t_lo, t_hi = cols
        q, t = tdev.gather_windows(reads2, panel_padded, q_start, m, t_start,
                                   t_lo, t_hi, bucket, band)
        return a1.band_dp_stats_ref(q, t, band, params)

    # As align_and_count runs it: A1's fused-fetch entry fetches every
    # piece from the chunk's buffers; then the plain version on the same
    # pieces' windows, gathered on the card.
    dd = tdev.upload(chunk.codes, genome["panel"], dev)
    band_dp_stats_flat = a1.band_dp_stats_flat
    runs = {}
    for name, dp in (("fused", fused_dp), ("plain", plain_dp)):
        timings = {}
        launches0 = a1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a1.band_dp_stats_flat = dp
        try:
            apipe.compute_winner_stats(chunk, genome["panel"], winners, cfg,
                                       dd, timings=timings)
        finally:
            a1.band_dp_stats_flat = band_dp_stats_flat
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, timings,
                      {f: getattr(winners, f).copy() for f in AUDIT_FIELDS},
                      a1.launches - launches0)
    fetched = sum(cols.shape[1] for cols in flat.values())
    if fetched != runs["fused"][1]["audit_pieces"] or runs["fused"][3] <= 0:
        fail(f"compute_winner_stats: A1 fetched {fetched} of "
             f"{runs['fused'][1]['audit_pieces']} pieces on the card in "
             f"{runs['fused'][3]} launches")
    if runs["plain"][3]:
        fail(f"compute_winner_stats with the plain version launched A1 "
             f"{runs['plain'][3]} times")
    for f in AUDIT_FIELDS:
        if not np.array_equal(runs["fused"][2][f], runs["plain"][2][f]):
            fail(f"compute_winner_stats with the fused-fetch stats kernel "
                 f"differs from the plain version in {f}")
    sizes = ", ".join(f"bucket {m}: {cols.shape[1]}"
                      for m, cols in sorted(flat.items()))
    for name, (secs, tm, _, n_launch) in runs.items():
        log(f"[stats] compute_winner_stats, {name} path: {secs:.3f} s, of "
            f"which table {tm['audit_table_s']:.3f} s, assembly "
            f"{tm['audit_assembly_s']:.3f} s "
            f"({100 * tm['audit_assembly_s'] / secs:.1f}%), DP calls to "
            f"their host results {tm['audit_dp_s']:.3f} s; A1 launches "
            f"{n_launch}")
    log(f"[stats] production chunk: matches, blocklen, rescore_deficit, "
        f"rescore_flag equal on the fused path and with the plain version; "
        f"pieces per bucket {sizes}; flagged "
        f"{int(runs['fused'][2]['rescore_flag'].sum())}")

    # The fused-fetch entry on the same production pieces, exactly against
    # the plain version on gathered windows: bands 256 and 512, narrow and
    # wide (mismatch -200).
    for bucket, cols in sorted(flat.items()):
        q_start, t_start, m, t_lo, t_hi = cols
        for band in (2 * cfg.band, 4 * cfg.band):
            for p in (DPParams(), DPParams(mismatch=-200)):
                got = band_dp_stats_flat(dd.reads2, dd.panel_padded, cols,
                                         bucket, band, p)
                q, t = tdev.gather_windows(dd.reads2, dd.panel_padded,
                                           q_start, m, t_start, t_lo, t_hi,
                                           bucket, band)
                ref = a1.band_dp_stats_ref(q, t, band, p)
                torch.cuda.synchronize()
                for key in a1.STATS_COLS:
                    e = int((got[key].to(torch.int64)
                             - ref[key].to(torch.int64)).abs().max())
                    max_err = max(max_err, e)
                    if e != 0:
                        fail(f"the fused-fetch stats kernel disagrees with "
                             f"the plain version: {key}, bucket {bucket} "
                             f"band {band} {p} (max abs err {e})")
                n_cases += 1
        log(f"[stats] fused fetch, production bucket {bucket} "
            f"({cols.shape[1]} pieces): exact at bands {2 * cfg.band} and "
            f"{4 * cfg.band}, narrow and wide")

    # The production shape: the chunk's bucket-2048 pieces, band 256, its
    # first 4,096 (the JAX package's slice) and the whole bucket, on their
    # gathered windows; the fused-fetch entry on the whole bucket's offsets.
    band = 2 * cfg.band
    cols = flat[max(flat)]
    q_start, t_start, m, t_lo, t_hi = cols
    q, t = tdev.gather_windows(dd.reads2, dd.panel_padded, q_start, m,
                               t_start, t_lo, t_hi, max(flat), band)
    times = {}
    gathered0 = a1.launches
    for label, qq, tt in (("4096", q[:4096], t[:4096]), ("bucket", q, t),
                          ("fused", q, t)):
        if label == "fused":
            gathered = a1.launches - gathered0
            run = lambda: band_dp_stats_flat(  # noqa: E731
                dd.reads2, dd.panel_padded, cols, qq.shape[1], band)
        else:
            compare(f"production {label}", qq, tt, band)
            run = lambda: a1.band_dp_stats(qq, tt, band)  # noqa: E731
        ms = cuda_time_ms(run, reps=10)
        plain_ms = cuda_time_ms(lambda: a1.band_dp_stats_ref(qq, tt, band),
                                reps=1, warm=label != "fused")
        # Bound: the rows each piece needs (to its last read code other
        # than the sentinel), each input byte once, 32 bytes out each.
        coded = qq != 4
        last = coded.flip(1).to(torch.uint8).argmax(1)
        rows = torch.where(coded.any(1), qq.shape[1] - last, 0)
        need = float(rows.sum())
        cells = need * band
        n_bytes = need + (need + band * qq.shape[0]) + 32 * qq.shape[0]
        bms, by = bound_ms(cells, OPS_PER_CELL["stats"], n_bytes, peak_ops)
        times[label] = (ms, plain_ms, bms, by)
        name = ("band_dp_stats_flat" if label == "fused"
                else "band_dp_stats")
        log(f"[stats] {name} P {qq.shape[0]} bucket {qq.shape[1]} band "
            f"{band}: kernel {ms:.3f} ms ({cells / ms / 1e6:.2f} Gcell/s), "
            f"plain {plain_ms:.3f} ms; bound {bms:.3f} ms by {by} "
            f"({cells / 1e9:.3f} Gcell x {OPS_PER_CELL['stats']} ops), "
            f"{100 * bms / ms:.1f}% of bound")
    log(f"[stats] {n_cases} exact comparisons, max abs err {max_err}")
    del flat, q, t, cols, winners, chunk, dd
    torch.cuda.empty_cache()
    return {name: {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "launches": launches}
            for name, launches, (ms, plain_ms, bms, by) in (
                ("gathered", gathered, times["bucket"]),
                ("flat", runs["fused"][3], times["fused"]))}


# ---- phase 4 ------------------------------------------------------------------


def vcf_records(path: Path):
    return [ln for ln in path.read_text().splitlines() if not ln.startswith("#")]


def gaf_winners(path: Path):
    """Winners of a ``--gaf`` file keyed by (read, strand, path, nth), with
    their window-free fields: read span (qs, qe) in the oriented read as the
    aligner reports it, path span (ts, te), score / 2 (GAF's matches column
    is min(block length, score // match), and every score here is even) and
    mapq."""
    winners, seen = {}, {}
    for line in path.read_text().splitlines():
        f = line.split("\t")
        rlen, qstart, qend = int(f[1]), int(f[2]), int(f[3])
        if f[4] == "-":  # GAF reports reverse-strand spans on the forward read
            qstart, qend = rlen - qend, rlen - qstart
        key = (f[0], f[4], f[5])
        seen[key] = nth = seen.get(key, -1) + 1
        winners[(*key, nth)] = {
            "qs": qstart, "qe": qend - 1, "ts": int(f[7]), "te": int(f[8]) - 1,
            "matches": int(f[9]), "mapq": int(f[11]),
        }
    return winners


def compare_winners(ours: Path, theirs: Path, engine: str) -> str:
    """Per field, how many winners two runs' GAF files disagree on."""
    a, b = gaf_winners(ours), gaf_winners(theirs)
    both = a.keys() & b.keys()
    fields = ("qs", "qe", "ts", "te", "matches", "mapq")
    diff = {k: sum(a[w][k] != b[w][k] for w in both) for k in fields}
    return (f"{len(both)} winners in both, {len(a.keys() - b.keys())} only "
            f"in {engine}, {len(b.keys() - a.keys())} only in v3; differing: "
            + ", ".join(f"{k} {v}" for k, v in diff.items()))


#: The one-pass engines run_pipeline can name, by the kernel each launches:
#: K3 (fetches its own windows) and G1 (on gathered windows).
ONEPASS_KERNELS = {"dma": "band_dp_dma", "gather": "band_dp_gather"}


def phase_onepass_path(out: Path, paths, n_reads, v3_prefix: Path,
                       engine: str):
    """A one-pass engine (``dma``: K3; ``gather``: G1) through run_pipeline;
    returns its DP kernel's and A1's launches."""
    import contextlib
    import importlib
    import io

    import torch

    from svjedi_tpu_torch.config import PipelineConfig
    from svjedi_tpu_torch.evals.contingency import contingency_report
    from svjedi_tpu_torch.kernels import band_dp_stats, band_dp_v3, dev_scan
    from svjedi_tpu_torch.pipeline import run_pipeline

    label = f"[{engine}-path]"
    kernels = {name: importlib.import_module(f"svjedi_tpu_torch.kernels.{name}")
               for name in ONEPASS_KERNELS.values()}
    kernel = ONEPASS_KERNELS[engine]
    prefix = out / engine
    cfg = PipelineConfig(vcf=paths["vcf"], ref=paths["ref"],
                         reads=(str(paths["reads"]),), prefix=str(prefix),
                         write_gaf=True)
    err = io.StringIO()
    for mod in (*kernels.values(), band_dp_v3, dev_scan, band_dp_stats):
        mod.launches = 0
    band_dp_v3.rev_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        run_pipeline(cfg, device=torch.device("cuda:0"), engine=engine)
    wall = time.perf_counter() - t0
    launches = kernels[kernel].launches
    others = {name: mod.launches for name, mod in kernels.items()
              if name != kernel}
    others["band_dp_v3"] = band_dp_v3.launches  # K1 and K1' both
    stats_launches = band_dp_stats.launches
    stderr = err.getvalue()
    for line in stderr.splitlines()[-8:]:
        log(f"{label} stderr: {line}")
    faults = [w for w in FAULT_WARNINGS if w in stderr]
    if faults:
        fail(f"fault warnings in the {engine} run: {faults}")
    if launches <= 0:
        fail(f"the {engine} path launched the {kernel} kernel no time")
    for name, n in others.items():
        if n != 0:
            fail(f"the {engine} path launched the {name} kernel {n} times")
    with open(f"{prefix}_stats.json") as fh:
        stats = json.load(fh)
    counters, timings = stats["counters"], stats["timings_s"]
    if counters.get("engine") != engine:
        fail(f"the {engine} run recorded engine {counters.get('engine')!r}")
    if counters.get(f"{kernel}_launches") != launches:
        fail(f"the {engine} run recorded {counters.get(f'{kernel}_launches')}"
             f" {kernel} launches, not {launches}")
    check_native(counters, f"the {engine} path")
    check_device_scan(counters, n_reads, f"the {engine} path")
    if stats_launches <= 0 or check_stats_launches(
            counters, f"the {engine} path") != stats_launches:
        fail(f"the {engine} path launched the band_dp_stats kernel "
             f"{stats_launches} times (stats: "
             f"{counters.get('band_dp_stats_launches')})")
    vcf = Path(f"{prefix}_genotype.vcf")
    report = contingency_report(paths["vcf"], str(vcf))
    acc = re.search(r"accuracy: ([\d.]+)", report)
    log(f"{label} " + " | ".join(report.strip().splitlines()))
    if acc is None or float(acc.group(1)) != 100.0:
        fail(f"{engine} genotyping accuracy is not 100.0")
    ours = vcf_records(vcf)
    theirs = vcf_records(Path(f"{v3_prefix}_genotype.vcf"))
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    n_diff = len(differ) + abs(len(ours) - len(theirs))
    for a, b in differ[:3]:  # engines may place tied optima differently
        fa, fb = a.split("\t"), b.split("\t")
        log(f"{label} differs at {fa[0]}:{fa[1]}: {engine} {fa[-1]} vs v3 "
            f"{fb[-1]}")
    # Engines agree on scores; among equally scoring optima each may pick
    # another span, and a span can move a read across a junction's rule.
    log(f"{label} winners (GAF) {engine} vs v3: "
        + compare_winners(Path(f"{prefix}.gaf"), Path(f"{v3_prefix}.gaf"),
                          engine))
    align_s = float(timings["align"])
    log(f"{label} run wall {wall:.1f} s; align stage {align_s:.2f} s, "
        f"{n_reads / align_s:.1f} reads/s; max_memory_allocated "
        f"{counters.get('device_max_memory_allocated')} bytes; {kernel} "
        f"launches {launches}; "
        + "; ".join(f"{name} launches {n}" for name, n in others.items())
        + f"; VCF records differing from the v3 run: {n_diff} of "
        f"{len(theirs)}; audit re-score warnings "
        f"{stderr.count(AUDIT_WARNING)}; "
        + audit_split(counters, stats_launches))
    return launches, stats_launches


def phase_pregathered_path(data, vecs, dma_out, bucket: int):
    """K4's entry on the windows of phase 2b's production batch."""
    import torch

    from svjedi_tpu_torch.kernels import band_dp as k4
    from svjedi_tpu_torch.align.device import gather_windows

    P = dma_out.shape[0]
    k4.launches = 0
    q_start, t_start, m, t_lo, t_hi = vecs
    q, t = gather_windows(data.reads2, data.panel_padded, q_start, m, t_start,
                          t_lo, t_hi, bucket, BAND)
    got = k4.band_dp_onepass(q, t, BAND)
    launches = k4.launches
    if launches <= 0:
        fail("the pre-gathered path launched the band_dp_onepass kernel no time")
    torch.cuda.synchronize()
    for c, key in enumerate(got):
        if not torch.equal(got[key], dma_out[:, c]):
            fail(f"band_dp_onepass on gathered windows differs from "
                 f"band_dp_dma in {key}")
    log(f"[pregathered-path] P {P} bucket {bucket}: gather_windows + "
        f"band_dp_onepass equals band_dp_dma; band_dp_onepass launches "
        f"{launches}")
    return launches


# ---- phase 2f -----------------------------------------------------------------

#: Where make_gather_problems puts two equal local alignments.
PAIR = 6


def make_gather_problems(seed: int, P: int, bucket: int, band: int):
    """make_problems' windows as (P, bucket) and (P, bucket + band) numpy
    int8 (ragged m, an empty read, an empty target, a problem scoring 0),
    then poly-A against poly-A, a dinucleotide and a trinucleotide tandem
    repeat, at PAIR two equal local alignments (the first ends at row 29
    on band offset band - 28, the second at row 69 on offset 20: the row
    rule reports the first, the per-cell rule the second), and 16 padding
    rows (all sentinel, as n_valid leaves them) at the end."""
    qT, tT, _ = make_problems(seed, P, bucket, sort_m=True, band=band)
    q, t = qT.T.copy(), tT.T.copy()
    width = bucket + band
    q[3], t[3] = 0, 0
    q[4], t[4] = np.resize([0, 1], bucket), np.resize([0, 1], width)
    q[5], t[5] = np.resize([2, 0, 3], bucket), np.resize([1, 2, 0, 3], width)
    pair = np.random.default_rng(5)
    x, y = (pair.integers(0, 4, 30).astype(np.int8) for _ in range(2))
    q[PAIR], t[PAIR] = 4, 4
    q[PAIR, :30], t[PAIR, band - 28:band + 2] = x, x
    q[PAIR, 40:70], t[PAIR, 60:90] = y, y
    q[-16:] = 4
    return q, t


def phase_gather_kernel(peak_ops: float):
    """G1: the gather engine's DP against its plain version on the card,
    exactly, on edge and tie cases at every bucket; times it."""
    import torch

    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.kernels import band_dp as k4
    from svjedi_tpu_torch.kernels import band_dp_gather as g1

    dev = torch.device("cuda:0")
    max_err = 0
    n_cases = 0

    def compare(tag, q, t, band, p=DPParams()):
        nonlocal max_err, n_cases
        got = g1.band_dp_gather(q, t, band, p)
        ref = g1.band_dp_gather_ref(q, t, band, p)
        torch.cuda.synchronize()
        for key in g1.GATHER_COLS:
            e = int((got[key].to(torch.int64) - ref[key].to(torch.int64))
                    .abs().max())
            max_err = max(max_err, e)
            if e != 0:
                fail(f"the gather kernel disagrees with its plain version: "
                     f"{key}, {tag} (max abs err {e})")
        n_cases += 1
        return got

    # Every bucket at band 128 (the pipeline's); bucket 2048 at band 256
    # and at 512, the kernel's other builds.
    cases = [(bucket, BAND) for bucket in AlignConfig().buckets]
    cases += [(2048, 256), (2048, 512)]
    for bucket, band in cases:
        t0 = time.perf_counter()
        q, t = make_gather_problems(bucket + band, 256, bucket, band)
        q, t = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
        tag = f"bucket={bucket} band={band}"
        got = compare(tag, q, t, band)
        pair = tuple(int(got[k][PAIR]) for k in g1.GATHER_COLS)
        if pair != (60, 0, band - 28, 29, band + 1):
            fail(f"two equal local alignments: G1's end is not the row rule "
                 f"({tag}: {pair})")
        # K4's per-cell end on the same windows: its kernel where it has a
        # build, else its plain version.
        onepass = (k4.band_dp_onepass if band in (128, 256)
                   else k4.band_dp_onepass_ref)
        per_cell = onepass(q, t, band)
        differ = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
        for key in g1.GATHER_COLS:
            differ |= got[key] != per_cell[key]
        n_differ = int(differ.sum())
        if not differ[PAIR]:
            fail(f"G1 and K4 report the same span for two equal local "
                 f"alignments ({tag})")
        extra = ""
        if bucket == 2048:
            # Every row runs (a zero gap open; a positive mismatch) and the
            # wide builds (a mismatch outside int8; scores past 2^16).
            for p in (DPParams(gap_open=2, gap_extend=-2),
                      DPParams(mismatch=1), DPParams(mismatch=-200),
                      DPParams(mismatch=100)):
                compare(f"{p} {tag}", q, t, band, p)
            extra = ("; also with a zero gap open, a positive mismatch and "
                     "in both wide builds")
        log(f"[gather] bucket {bucket:5d} band {band} P 256: band_dp_gather "
            f"exact{extra}; K4's per-cell end differs on {n_differ} problems "
            f"({time.perf_counter() - t0:.1f} s)")

    # The production shape of phase 2b (P = 32768, bucket 2048, band 128).
    P, bucket = 32768, 2048
    qT, tT, _ = make_problems(7, P, bucket, sort_m=True)
    q = torch.from_numpy(qT.T.copy()).to(dev)
    t = torch.from_numpy(tT.T.copy()).to(dev)
    compare("P=32768 bucket=2048", q, t, BAND)
    ms = cuda_time_ms(lambda: g1.band_dp_gather(q, t, BAND), reps=10)
    plain_ms = cuda_time_ms(lambda: g1.band_dp_gather_ref(q, t, BAND), reps=1,
                            warm=True)
    # Bound: the rows each problem needs (to its last read code other than
    # the sentinel), each input byte once, 32 bytes out each.
    coded = qT[::-1] != 4
    need = np.where(coded.any(axis=0), bucket - coded.argmax(axis=0), 0)
    need = float(need.astype(np.int64).sum())
    cells = need * BAND
    n_bytes = need + (need + BAND * P) + 32 * P
    ops = OPS_PER_CELL["band_dp_gather"]
    bms, by = bound_ms(cells, ops, n_bytes, peak_ops)
    log(f"[gather] band_dp_gather P {P} bucket {bucket} band {BAND}: kernel "
        f"{ms:.3f} ms ({cells / ms / 1e6:.2f} Gcell/s), plain "
        f"{plain_ms:.3f} ms; bound {bms:.3f} ms by {by} "
        f"({cells / 1e9:.3f} Gcell x {ops} ops), {100 * bms / ms:.1f}% of "
        f"bound; {n_cases} exact comparisons, max abs err {max_err}")
    del q, t
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


# ---- phase 5 ------------------------------------------------------------------


def memlog_peaks(path: Path) -> dict:
    """The bench's ``SVJT_SCALE_MEMLOG`` file checked against the JAX
    bench's format and phase order; returns each label's peak rss_gb."""
    from svjedi_tpu_torch.bench import MEMLOG_PHASES

    lines = path.read_text().splitlines()
    if not lines or lines[0] != "t_s\trss_gb\tphase":
        fail(f"the bench's memlog header is {lines[:1]}")
    rows = [ln.split("\t") for ln in lines[1:]]
    if not rows or any(len(r) != 3 for r in rows):
        fail(f"the bench's memlog has {len(rows)} rows, some malformed")
    peaks: dict = {}
    for _, rss, label in rows:
        peaks[label] = max(peaks.get(label, 0.0), float(rss))
    labels = [r[2] for r in rows]
    order = [lab for i, lab in enumerate(labels)
             if i == 0 or lab != labels[i - 1]]
    if order[0] == "start":  # the sampler's first row may precede "sim"
        order = order[1:]
    if order != list(MEMLOG_PHASES[1:]):
        fail(f"the bench's memlog labels run {order}, not "
             f"{list(MEMLOG_PHASES[1:])}")
    return peaks


def phase_bench(out: Path, timeout: int = 900) -> float:
    """The port's bench, scale configuration, as a user runs it, with its
    phase-tagged memory profile."""
    cmd = [sys.executable, "-m", "svjedi_tpu_torch.bench"]
    memlog = out / "bench_memlog.tsv"
    env = dict(os.environ, SVJT_BENCH_CONFIG="scale",
               SVJT_SCALE_MEMLOG=str(memlog))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=timeout)
    for line in proc.stderr.splitlines():
        if line.startswith(("[bench]", "[scale]")):
            log(f"[bench] stderr: {line}")
    if proc.returncode != 0:
        for line in proc.stderr.splitlines()[-10:]:
            log(f"[bench] stderr: {line}")
        fail(f"svjedi_tpu_torch.bench exited {proc.returncode}: "
             f"{proc.stdout.strip()}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"the bench printed {len(lines)} lines on stdout, not one")
    result = json.loads(lines[0])
    if (result.get("metric") != "scale_reads_per_s_per_chip"
            or not result.get("value", 0) > 0):
        fail(f"the bench's result is not a positive scale metric: {result}")
    log(f"[bench] {lines[0]}")
    scale = [ln for ln in proc.stderr.splitlines() if ln.startswith("[scale]")]
    if not scale or "post_align_resident_gb=" not in scale[0]:
        fail("the bench's [scale] line lacks post_align_resident_gb")
    peaks = memlog_peaks(memlog)
    log("[bench] memlog peak rss_gb by phase: " + ", ".join(
        f"{label} {gb:.2f}" for label, gb in peaks.items()))
    return float(result["value"])


# ---- phase 6 ------------------------------------------------------------------


def cuda_wall_s(fn, reps: int) -> float:
    """Median host seconds of ``fn()`` to a synchronised card."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_dist_step(paths):
    """The sharded count step at production width on a 2 x 2 mesh of
    cuda:0, then the one-device ``xla`` step (phase_xla_step); returns the
    sharded step's K1 and K1' launches and the xla step's G1 launches."""
    import torch

    from svjedi_tpu_torch.dist.engine import (
        assert_no_group_straddle, dp_filter_count_v3,
        make_sharded_count_step_v3,
    )
    from svjedi_tpu_torch.dist.mesh import make_mesh
    from svjedi_tpu_torch.entry import production_problem
    from svjedi_tpu_torch.io.fasta import read_fasta
    from svjedi_tpu_torch.io.fastq import read_reads
    from svjedi_tpu_torch.kernels import band_dp_v3

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    reads = read_reads(str(paths["reads"]))
    reads = reads.slice(0, min(reads.n_reads, 16384))
    prob = production_problem(
        data_shards=2, device=dev, reads=reads,
        genome=(read_fasta(paths["ref"]), str(paths["vcf"])), bucket=2048,
    )
    assert_no_group_straddle(prob["group"], prob["meta"], 2)
    if not all(prob["real_per_shard"]):
        fail(f"a data shard holds no candidate: {prob['real_per_shard']}")
    P = prob["meta"].shape[1]
    args = (*prob["data"].packed_words(),
            *(torch.from_numpy(prob[k]).to(dev)
              for k in ("meta", "path_start", "group", "cand_path")),
            prob["owned"])
    kw = dict(bucket=prob["bucket"], band=prob["band"], params=prob["params"],
              n_tags=prob["n_tags"])
    log(f"[dist] production problem: {reads.n_reads} reads, {prob['n_real']} "
        f"candidates ({prob['real_per_shard']} per data shard, P {P}), "
        f"{prob['n_groups']} groups, {prob['n_tags']} tags, bucket "
        f"{prob['bucket']} ({time.perf_counter() - t0:.1f} s)")

    mesh = make_mesh(data_shards=2, graph_shards=2, devices=[dev] * 4)
    step = make_sharded_count_step_v3(
        mesh, n_groups_per_shard=prob["n_groups"], engine="v3", **kw)
    band_dp_v3.launches = band_dp_v3.rev_launches = 0
    got = step(*args)
    torch.cuda.synchronize()
    rev_launches = band_dp_v3.rev_launches
    fwd_launches = band_dp_v3.launches - rev_launches
    if fwd_launches <= 0 or rev_launches <= 0:
        fail(f"the sharded step launched K1 {fwd_launches} and K1' "
             f"{rev_launches} times")

    def single(engine):
        return dp_filter_count_v3(*args, n_groups=prob["n_groups"],
                                  engine=engine, **kw)["counts"]

    t0 = time.perf_counter()
    ref = single("v3i")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got, ref):
        n_bad = int((got != ref).sum())
        fail(f"the sharded step's counts differ from the plain one-device "
             f"step in {n_bad} entries")
    total = int(got.sum())
    if total <= 0:
        fail("the sharded step counted no support")
    sharded_s = cuda_wall_s(lambda: step(*args), reps=3)
    single_s = cuda_wall_s(lambda: single("v3"), reps=3)
    log(f"[dist] sharded step (2 x 2 mesh of cuda:0, v3) == one-device step "
        f"on the plain versions (v3i): counts exact, sum {total}; K1 "
        f"launches {fwd_launches}, K1' {rev_launches}; sharded step "
        f"{sharded_s:.3f} s, one-device v3 step {single_s:.3f} s, plain "
        f"(v3i) {plain_s:.3f} s (host clock to a synchronised card, medians "
        f"of 3, 3 and 1 calls)")
    g1_launches = phase_xla_step(args, kw, prob["n_groups"], got)
    del prob, args, got, ref
    torch.cuda.empty_cache()
    return fwd_launches, rev_launches, g1_launches


#: Every output of the count step.
STEP_OUTPUTS = ("counts", "score", "qs", "ts", "qe", "te", "is_winner")


def span_scores(qT, tT, out, idx, toff, band: int, params):
    """The best score of problems ``idx`` on their windows clamped to the
    spans in ``out`` (read rows qs..qe, target columns ts..te, path
    coordinates less ``toff``): the score ``out`` claims exactly where the
    span holds an optimal alignment."""
    import torch

    from svjedi_tpu_torch.kernels import band_dp_gather as g1

    q, t = qT[:, idx].T, tT[:, idx].T
    rows = torch.arange(q.shape[1], device=q.device)
    cols = torch.arange(t.shape[1], device=q.device)
    qs, qe = out["qs"][idx, None], out["qe"][idx, None]
    ts, te = (out["ts"][idx] - toff)[:, None], (out["te"][idx] - toff)[:, None]
    q = torch.where((rows >= qs) & (rows <= qe), q, 4).to(torch.int8)
    t = torch.where((cols >= ts) & (cols <= te), t, 4).to(torch.int8)
    return g1.band_dp_gather(q.contiguous(), t.contiguous(), band,
                             params)["score"]


def phase_xla_step(args, kw, n_groups: int, sharded_counts):
    """The dry run's one-device truth, the ``xla`` step, on the card: it
    must launch G1, equal the same step on G1's plain version in every
    output, and count what the sharded ``v3`` step counts. Returns G1's
    launches."""
    import torch

    from svjedi_tpu_torch.align.device import _prep_v3_windows_packed
    from svjedi_tpu_torch.dist.engine import dp_filter_count_v3
    from svjedi_tpu_torch.kernels import band_dp_gather as g1

    def step(engine):
        return dp_filter_count_v3(*args, n_groups=n_groups, engine=engine,
                                  **kw)

    g1.launches = 0
    xla = step("xla")
    torch.cuda.synchronize()
    launches = g1.launches
    if launches <= 0:
        fail("the xla count step launched the band_dp_gather kernel no time")
    kernel = g1.band_dp_gather
    g1.band_dp_gather = g1.band_dp_gather_ref  # band_dp_batch's route
    try:
        t0 = time.perf_counter()
        plain = step("xla")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        g1.band_dp_gather = kernel
    for key in STEP_OUTPUTS:
        if not torch.equal(xla[key], plain[key]):
            fail(f"the xla step with G1 differs from the step on its plain "
                 f"version in {key}")
    qT, tT = _prep_v3_windows_packed(*args[:5], kw["bucket"], kw["band"])
    agree = "counts equal to the sharded v3 step's"
    if not torch.equal(xla["counts"], sharded_counts):
        # The engines agree on scores, not on spans: xla ends by the row
        # rule with G1's starts, v3 by K1's per-cell rule with K1′'s
        # starts. Counts may then differ only through winners whose spans
        # are each an optimal alignment's (tied optima).
        v3 = step("v3")
        bad = (xla["counts"] != sharded_counts).any(dim=1).nonzero()[:, 0]
        log(f"[dist] xla counts differ from the sharded v3 step's at tags "
            f"{bad.tolist()[:20]}: xla {xla['counts'][bad].tolist()[:20]}, "
            f"v3 {sharded_counts[bad].tolist()[:20]}")
        moved = torch.stack([xla[k] != v3[k]
                             for k in STEP_OUTPUTS[1:]]).any(dim=0)
        moved = (moved & (xla["is_winner"] | v3["is_winner"])).nonzero()[:, 0]
        for i in moved[:10].tolist():
            log(f"[dist] candidate {i}: " + "; ".join(
                f"{name} " + " ".join(f"{k} {int(out[k][i])}"
                                      for k in STEP_OUTPUTS[1:])
                for name, out in (("xla", xla), ("v3", v3))))
        if len(moved) == 0:
            fail("the xla step's counts differ from the sharded v3 step's "
                 "with the same winners and spans")
        if not torch.equal(xla["score"][moved], v3["score"][moved]):
            fail("the xla step's counts differ from the sharded v3 step's, "
                 "and so do the winners' scores: not a tie")
        toff = (args[4][2] - args[5])[moved]
        for name, out in (("xla", xla), ("v3", v3)):
            held = span_scores(qT, tT, out, moved, toff, kw["band"],
                               kw["params"])
            short = moved[held != out["score"][moved]]
            if len(short):
                fail(f"the xla step's counts differ from the sharded v3 "
                     f"step's, and the {name} span of candidates "
                     f"{short.tolist()[:10]} holds no optimal alignment")
        agree = (f"counts differ from the sharded v3 step's at {len(bad)} "
                 f"tags (sums {int(xla['counts'].sum())} and "
                 f"{int(sharded_counts.sum())}); every one of the "
                 f"{len(moved)} winners whose span or status moved has "
                 f"equal scores and both spans optimal (tied optima)")
    xla_s = cuda_wall_s(lambda: step("xla"), reps=3)
    copy_ms = cuda_time_ms(lambda: (qT.T.contiguous(), tT.T.contiguous()),
                           reps=10)
    log(f"[dist] one-device xla step (G1): every output equal to the step on "
        f"G1's plain version, {agree}; G1 "
        f"launches {launches}; xla step {xla_s:.3f} s (median of 3), on the "
        f"plain version {plain_s:.3f} s (1 call); its copy of the "
        f"transposed windows {copy_ms:.3f} ms (CUDA events, {qT.shape[1]} "
        f"problems x {qT.shape[0]} + {tT.shape[0]} bytes)")
    return launches


def phase_dist_run(out: Path, paths, v3_prefix: Path):
    """``run_pipeline`` with --data-shards 2 --graph-shards 2 on four
    entries of cuda:0; returns its K1 and K1' launches."""
    import contextlib
    import io

    import torch

    from svjedi_tpu_torch.config import DistConfig, PipelineConfig
    from svjedi_tpu_torch.evals.contingency import contingency_report
    from svjedi_tpu_torch.kernels import band_dp_stats, band_dp_v3
    from svjedi_tpu_torch.pipeline import run_pipeline

    dev = torch.device("cuda:0")
    prefix = out / "dist"
    cfg = PipelineConfig(vcf=paths["vcf"], ref=paths["ref"],
                         reads=(str(paths["reads"]),), prefix=str(prefix),
                         dist=DistConfig(data_shards=2, graph_shards=2))
    err = io.StringIO()
    band_dp_v3.launches = band_dp_v3.rev_launches = 0
    band_dp_stats.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        run_pipeline(cfg, device=dev, devices=[dev] * 4)
    wall = time.perf_counter() - t0
    rev_launches = band_dp_v3.rev_launches
    fwd_launches = band_dp_v3.launches - rev_launches
    stats_launches = band_dp_stats.launches
    stderr = err.getvalue()
    for line in stderr.splitlines()[-8:]:
        log(f"[dist-run] stderr: {line}")
    faults = [w for w in FAULT_WARNINGS if w in stderr]
    if faults:
        fail(f"fault warnings in the --data-shards/--graph-shards run: "
             f"{faults}")
    if fwd_launches <= 0 or rev_launches <= 0:
        fail(f"the --data-shards/--graph-shards run launched K1 "
             f"{fwd_launches} and K1' {rev_launches} times")
    with open(f"{prefix}_stats.json") as fh:
        stats = json.load(fh)
    counters, timings = stats["counters"], stats["timings_s"]
    if stats_launches <= 0 or check_stats_launches(
            counters, "the --data-shards/--graph-shards run") != stats_launches:
        fail(f"the --data-shards/--graph-shards run launched the "
             f"band_dp_stats kernel {stats_launches} times")
    for key, want in (("data_shards", 2), ("mesh", "2x2"),
                      ("seed_path", "device"), ("engine", "v3")):
        if counters.get(key) != want:
            fail(f"the --data-shards/--graph-shards run recorded {key} "
                 f"{counters.get(key)!r}, not {want!r}")
    vcf = Path(f"{prefix}_genotype.vcf")
    report = contingency_report(paths["vcf"], str(vcf))
    acc = re.search(r"accuracy: ([\d.]+)", report)
    log("[dist-run] " + " | ".join(report.strip().splitlines()))
    if acc is None or float(acc.group(1)) != 100.0:
        fail("--data-shards/--graph-shards genotyping accuracy is not 100.0")
    if vcf.read_bytes() != Path(f"{v3_prefix}_genotype.vcf").read_bytes():
        fail("the --data-shards 2 --graph-shards 2 VCF differs from phase 3's")
    log(f"[dist-run] run wall {wall:.1f} s; align stage "
        f"{float(timings['align']):.2f} s, mesh_count "
        f"{float(timings['mesh_count']):.3f} s; VCF byte-equal to phase 3's; "
        f"K1 launches {fwd_launches}, K1' {rev_launches}; dev_scan launches "
        f"{counters.get('dev_scan_launches')}; max_memory_allocated "
        f"{counters.get('device_max_memory_allocated')} bytes; "
        + audit_split(counters, stats_launches))
    return fwd_launches, rev_launches, stats_launches


# ---- phase 7 ------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_multihost(out: Path, paths, single_vcf: Path, mb: int,
                    timeout: int = 600):
    """Two ``run --multihost`` processes in a gloo group on cuda:0; process
    0's VCF must equal ``single_vcf``."""
    prefix = out / f"mh{mb}"
    cmd = [sys.executable, "-m", "svjedi_tpu_torch", "run",
           "-v", str(paths["vcf"]), "-r", str(paths["ref"]),
           "-q", str(paths["reads"]), "-p", str(prefix), "--multihost",
           "--no-artifacts"]
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank))
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        logs.append((out / f"mh{mb}_rank{rank}.out",
                     out / f"mh{mb}_rank{rank}.err"))
        with open(logs[-1][0], "w") as o, open(logs[-1][1], "w") as e:
            procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                          stdout=o, stderr=e, text=True))
    # Wait for both; a process that fails or outlives the limit ends both
    # (its peer would wait at the group's barrier).
    try:
        while any(proc.poll() is None for proc in procs):
            if (any(proc.returncode not in (None, 0) for proc in procs)
                    or time.perf_counter() - t0 > timeout):
                break
            time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for rank, (proc, (_, err_path)) in enumerate(zip(procs, logs)):
        stderr = err_path.read_text()
        for line in stderr.splitlines()[-6:]:
            log(f"[multihost] rank {rank} stderr: {line}")
        if proc.returncode != 0:
            fail(f"--multihost process {rank} exited {proc.returncode} after "
                 f"{wall:.1f} s (limit {timeout} s)")
        faults = [w for w in FAULT_WARNINGS if w in stderr]
        if faults:
            fail(f"fault warnings in --multihost process {rank}: {faults}")
    stats, timings = [], []
    for name in (f"{prefix}_stats.json", f"{prefix}.host1_stats.json"):
        with open(name) as fh:
            run = json.load(fh)
        stats.append(run["counters"])
        timings.append(run["timings_s"])
    stats_launches = 0
    for rank, counters in enumerate(stats):
        if counters.get("process") != f"{rank}/2":
            fail(f"--multihost process {rank} recorded process "
                 f"{counters.get('process')!r}")
        stats_launches += check_stats_launches(
            counters, f"--multihost process {rank}")
    if Path(f"{prefix}_genotype.vcf").read_bytes() != single_vcf.read_bytes():
        fail("the two-process --multihost VCF differs from the single run's")
    log(f"[multihost] two processes on {stats[0].get('device')} and "
        f"{stats[1].get('device')}, reads {stats[0].get('process_block')} and "
        f"{stats[1].get('process_block')}: process 0's VCF byte-equal to the "
        f"single-process run's ({mb} Mb); wall {wall:.1f} s; align stage "
        + " and ".join(f"{float(t['align']):.2f} s" for t in timings)
        + ", count_allreduce (barrier wait included) "
        + " and ".join(f"{float(t['count_allreduce']):.3f} s"
                       for t in timings)
        + "; band_dp_v3 launches (reverse kernel) "
        + " and ".join(f"{c.get('band_dp_v3_launches')} "
                       f"({c.get('band_dp_v3_rev_launches')})" for c in stats)
        + "; band_dp_stats launches "
        + " and ".join(str(c.get("band_dp_stats_launches")) for c in stats))
    return stats_launches


#: The script's clock limit for the 10 Mb bundle in phases 7 and 8: past
#: it they run on a 1 Mb bundle (``small_bundle``).
BUDGET_S = 1000.0


@functools.lru_cache(maxsize=None)
def small_bundle(out: Path):
    """A 1 Mb / 100 SV / 20x bundle and its single-process ``run`` (the
    reference of phases 7 and 8 when the 10 Mb bundle would not fit the
    clock); returns its paths and the run's prefix."""
    small = out / "small"
    small.mkdir()
    spaths, _ = simulate_bundle(small, 1, 100, 20.0)
    cmd = [sys.executable, "-m", "svjedi_tpu_torch", "run",
           "-v", str(spaths["vcf"]), "-r", str(spaths["ref"]),
           "-q", str(spaths["reads"]), "-p", str(small / "single")]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"the 1 Mb single-process run exited {proc.returncode}: "
             f"{proc.stderr[-500:]}")
    return spaths, small / "single"


def phase_multihost_any(out: Path, paths, v3_prefix: Path, t_start: float,
                        phase3_wall: float):
    """Phase 7 on the 10 Mb bundle if the script's clock allows, else on a
    1 Mb bundle beside its own single-process run."""
    # Two processes on one card and 8 cores: allow twice phase 3's wall.
    if time.perf_counter() - t_start + 2 * phase3_wall < BUDGET_S:
        return phase_multihost(out, paths, Path(f"{v3_prefix}_genotype.vcf"),
                               10)
    spaths, single = small_bundle(out)
    return phase_multihost(out / "small", spaths,
                           Path(f"{single}_genotype.vcf"), 1)


# ---- phase 8 ------------------------------------------------------------------


#: The kernels of `run`'s path, whose launches phase 8 gates.
RUN_KERNELS = ("K1", "K1'", "D1", "A1")


def reset_run_launches() -> None:
    from svjedi_tpu_torch.kernels import band_dp_stats, band_dp_v3, dev_scan

    band_dp_v3.launches = band_dp_v3.rev_launches = 0
    dev_scan.launches = band_dp_stats.launches = 0


def run_launches() -> dict:
    """Launches of `run`'s kernels since ``reset_run_launches``."""
    from svjedi_tpu_torch.kernels import band_dp_stats, band_dp_v3, dev_scan

    rev = band_dp_v3.rev_launches
    return {"K1": band_dp_v3.launches - rev, "K1'": rev,
            "D1": dev_scan.launches, "A1": band_dp_stats.launches}


def accuracy_of(truth_vcf, vcf):
    """The genotyping accuracy of ``vcf`` against the truth, and the
    contingency report on one line."""
    from svjedi_tpu_torch.evals.contingency import contingency_report

    report = contingency_report(str(truth_vcf), str(vcf))
    acc = re.search(r"accuracy: ([\d.]+)", report)
    return (float(acc.group(1)) if acc else None,
            " | ".join(report.strip().splitlines()))


def mode_run(label: str, paths, prefix: Path, aligns: bool = True, **cfg_kw):
    """One ``run_pipeline`` call of phase 8 on cuda:0 in this process, with
    ``PipelineConfig(**cfg_kw)``. A run that aligns must launch K1, K1', D1
    (one launch per chunk) and A1 and load the port's native library; one
    that does not (``--resume``) must launch none of them. No fault or
    audit warning may appear. Returns its stats counters and timings, the
    launches and the call's wall seconds."""
    import contextlib
    import io

    import torch

    from svjedi_tpu_torch.config import PipelineConfig
    from svjedi_tpu_torch.pipeline import run_pipeline

    cfg = PipelineConfig(vcf=paths["vcf"], ref=paths["ref"],
                         reads=(str(paths["reads"]),), prefix=str(prefix),
                         **cfg_kw)
    err = io.StringIO()
    reset_run_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        run_pipeline(cfg, device=torch.device("cuda:0"))
    wall = time.perf_counter() - t0
    launches = run_launches()
    stderr = err.getvalue()
    warned = [w for w in (*FAULT_WARNINGS, AUDIT_WARNING) if w in stderr]
    if warned:
        for line in stderr.splitlines()[-8:]:
            log(f"[modes] {label} stderr: {line}")
        fail(f"warnings in the {label} run: {warned}")
    stats_path = (f"{prefix}.shard{cfg.shard[0]}of{cfg.shard[1]}_stats.json"
                  if cfg.shard else f"{prefix}_stats.json")
    with open(stats_path) as fh:
        stats = json.load(fh)
    counters, timings = stats["counters"], stats["timings_s"]
    if aligns:
        missing = [k for k in RUN_KERNELS if launches[k] <= 0]
        if missing:
            fail(f"the {label} run launched {missing} no time: {launches}")
        check_native(counters, f"the {label} run")
        check_device_scan(counters, int(counters["n_reads"]),
                          f"the {label} run")
        if counters.get("band_dp_stats_launches") != launches["A1"]:
            fail(f"the {label} run recorded "
                 f"{counters.get('band_dp_stats_launches')} A1 launches, "
                 f"not {launches['A1']}")
        check_stats_launches(counters, f"the {label} run")
    elif any(launches.values()):
        fail(f"the {label} run launched kernels: {launches}")
    align = (f"align stage {float(timings['align']):.2f} s "
             f"({counters.get('n_reads')} reads)" if aligns else "no align")
    log(f"[modes] {label}: run wall {wall:.1f} s; {align}; "
        f"max_memory_allocated {counters.get('device_max_memory_allocated')} "
        f"bytes; launches " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + (f"; {audit_split(counters, launches['A1'])}" if aligns else ""))
    return counters, timings, launches, wall


def kernel_of(name: str):
    """Which of `run`'s kernels a trace's kernel event is (demangled or
    mangled name), or None; K1' is the kRev build of band_dp_v3_kernel."""
    if "dev_scan_kernel" in name:
        return "D1"
    if "band_dp_stats_kernel" in name:
        return "A1"
    if "band_dp_v3_kernel" in name:
        args = re.search(r"band_dp_v3_kernel<([^>]*)>", name)
        if args:
            rev = args.group(1).split(",")[-1].strip() == "true"
        else:
            rev = re.search(r"band_dp_v3_kernelI.*?Lb([01])EE", name)
            rev = rev is not None and rev.group(1) == "1"
        return "K1'" if rev else "K1"
    return None


def device_busy(trace_path: Path) -> dict:
    """From a torch.profiler trace: the union of the device's kernel, memcpy
    and memset intervals over the profiled window (the span of all the
    trace's events), the kernels by total time and the longest idle gaps.
    Fails if the trace holds no kernel event (no CUDA tracing) or misses
    one of `run`'s kernels."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    if not kernels:
        fail(f"the profiler trace holds no CUDA kernel event ({len(events)} "
             f"events): torch.profiler did not trace the card")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    merged = []
    for s, e in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in gpu):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [t0] + [x for span in merged for x in span] + [t1]
    gaps = sorted(((edges[2 * i + 1] - edges[2 * i], edges[2 * i] - t0)
                   for i in range(len(merged) + 1)), reverse=True)
    by_name: dict = {}
    for e in kernels:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + float(e["dur"]), n + 1)
    found = {kernel_of(name) for name in by_name} - {None}
    if found != set(RUN_KERNELS):
        fail(f"the trace's kernels miss {set(RUN_KERNELS) - found}: "
             f"{sorted(by_name)[:12]}")
    return {"window_us": t1 - t0, "busy_us": busy, "n_events": len(events),
            "n_gpu": len(gpu), "top": sorted(by_name.items(),
                                             key=lambda kv: -kv[1][0])[:5],
            "gaps": gaps[:5],
            "names": {kernel_of(n): n for n in by_name if kernel_of(n)}}


def phase_modes(out: Path, paths, ref_prefix: Path, want_acc: float):
    """Phase 8: every `run` mode not run on the card before, against the
    reference run at ``ref_prefix``, each at accuracy ``want_acc``; returns
    each mode's launches."""
    import shutil

    from svjedi_tpu_torch.config import DistConfig

    ref_vcf = Path(f"{ref_prefix}_genotype.vcf").read_bytes()
    modes = {}

    def same_vcf(prefix: Path, label: str):
        vcf = Path(f"{prefix}_genotype.vcf")
        if vcf.read_bytes() != ref_vcf:
            fail(f"the {label} VCF differs from the reference run's")
        acc, report = accuracy_of(paths["vcf"], vcf)
        if acc != want_acc:
            fail(f"the {label} run's genotyping accuracy is {acc}, not "
                 f"{want_acc}")
        log(f"[modes] {label}: VCF byte-equal to the reference run's; "
            + report)

    # Eager loading, no intermediate files.
    label = "--no-stream --no-artifacts"
    prefix = out / "eager"
    counters, timings, modes[label], wall = mode_run(
        label, paths, prefix, stream_reads=False, keep_artifacts=False)
    eager_untimed = wall - sum(float(v) for v in timings.values())
    if counters.get("read_loader") == "stream":
        fail(f"the {label} run streamed its reads")
    written = [s for s in ("_informative_aln.json", ".gfa", "_svs_edges.json",
                           "_ignored_svs.txt")
               if Path(f"{prefix}{s}").exists()]
    if written:
        fail(f"the {label} run wrote {written}")
    same_vcf(prefix, label)

    # Two shards (the second with two decoy shards), then the host merge.
    prefix = out / "sharded"
    shard_counters = []
    for i, extra in ((0, {}), (1, {"dist": DistConfig(decoy_shards=2)})):
        label = f"--shard {i}/2" + (" --decoy-shards 2" if extra else "")
        counters, _, modes[label], _ = mode_run(label, paths, prefix,
                                                shard=(i, 2), **extra)
        if counters.get("shard") != f"{i}/2":
            fail(f"the {label} run recorded shard {counters.get('shard')!r}")
        shard_counters.append(counters)
    if shard_counters[1].get("decoy_shards") != 2:
        fail(f"--shard 1/2 --decoy-shards 2 recorded decoy_shards "
             f"{shard_counters[1].get('decoy_shards')!r}")
    cmd = [sys.executable, "-m", "svjedi_tpu_torch", "merge",
           "-v", str(paths["vcf"]), "-p", str(prefix), "-n", "2"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"merge exited {proc.returncode}: {proc.stderr[-500:]}")
    log(f"[modes] merge -n 2: {time.perf_counter() - t0:.1f} s; shards' "
        f"reads {shard_counters[0].get('n_reads')} and "
        f"{shard_counters[1].get('n_reads')}")
    same_vcf(prefix, "--shard 0/2, --shard 1/2 --decoy-shards 2, merge")

    # Resume from a copy of the reference run's audit table.
    label = "--resume"
    prefix = out / "resumed"
    shutil.copy(f"{ref_prefix}_informative_aln.json",
                f"{prefix}_informative_aln.json")
    counters, _, modes[label], _ = mode_run(label, paths, prefix,
                                            aligns=False, resume=True)
    if "resumed_from" not in counters:
        fail("the --resume run did not resume")
    same_vcf(prefix, label)

    # torch.profiler around the align stage.
    label = "--profile-dir"
    prefix = out / "profiled"
    trace = out / "profile" / "trace.json"
    counters, timings, modes[label], wall = mode_run(
        label, paths, prefix, profile_dir=str(trace.parent))
    untimed = wall - sum(float(v) for v in timings.values())
    if not trace.exists():
        fail("the --profile-dir run wrote no trace.json")
    t0 = time.perf_counter()
    busy = device_busy(trace)
    share = busy["busy_us"] / busy["window_us"]
    log(f"[profile] trace {trace.stat().st_size} bytes, {busy['n_events']} "
        f"events ({busy['n_gpu']} on the device), read in "
        f"{time.perf_counter() - t0:.1f} s; the run's seconds outside its "
        f"timed stages {untimed:.1f} (trace export included; the eager "
        f"run's {eager_untimed:.1f})")
    log(f"[profile] device busy share of the align stage: {100 * share:.2f}% "
        f"({busy['busy_us'] / 1e3:.1f} ms of a {busy['window_us'] / 1e3:.1f} "
        f"ms profiled window; align stage {float(timings['align']):.2f} s); "
        f"idle {100 * (1 - share):.2f}%")
    for name, (tot, n) in busy["top"]:
        log(f"[profile] kernel {tot / 1e3:9.3f} ms, {n:5d} launches: "
            f"{name[:100]}")
    for length, at in busy["gaps"]:
        log(f"[profile] idle gap {length / 1e3:9.3f} ms at "
            f"{at / 1e3:.1f} ms")
    log("[profile] run kernels in the trace: " + "; ".join(
        f"{k} = {n[:60]}" for k, n in sorted(busy["names"].items())))
    same_vcf(prefix, label)
    return modes


def phase_modes_any(out: Path, paths, v3_prefix: Path, t_start: float,
                    phase3_wall: float):
    """Phase 8 on the 10 Mb bundle if the script's clock allows, else on the
    1 Mb bundle of ``small_bundle``. The 10 Mb runs must reach accuracy
    100.0, as phase 3 does; the 1 Mb runs the accuracy of their single
    run (99.0 on the card: one false positive)."""
    # Five in-process runs and a merge, then phase 9: about four of phase
    # 3's walls (3.4 and 0.2 on an H100).
    if time.perf_counter() - t_start + 4 * phase3_wall < BUDGET_S:
        return phase_modes(out, paths, v3_prefix, 100.0)
    spaths, single = small_bundle(out)
    acc, report = accuracy_of(spaths["vcf"], f"{single}_genotype.vcf")
    log(f"[modes] on the 1 Mb bundle (the 10 Mb runs would pass the clock); "
        f"its single run: {report}")
    if acc is None:
        fail("the 1 Mb single run's report has no accuracy")
    return phase_modes(out / "small", spaths, single, acc)


# ---- phase 9 ------------------------------------------------------------------


def phase_scaling(paths):
    """Phase 9: ``bench_scaling.measure`` on phase 3's bundle on cuda:0;
    returns its K1 and K1' launches."""
    import torch

    from svjedi_tpu_torch import bench_scaling

    t0 = time.perf_counter()
    res = bench_scaling.measure(paths["ref"], paths["vcf"], paths["reads"],
                                torch.device("cuda:0"))
    log(f"[scaling] {json.dumps(res.line)}")
    line = res.line
    if list(line) != list(bench_scaling.KEYS):
        fail(f"the tool's line has keys {list(line)}")
    if (line["platform"], line["engine"]) != ("cuda", "v3"):
        fail(f"the tool ran {line['engine']} on {line['platform']}")
    P = line["n_problems"]
    if P <= 0 or P % 1024:
        fail(f"the tool's n_problems {P} is not a positive multiple of 1024")
    if res.k1_launches <= 0 or res.k1_rev_launches <= 0:
        fail(f"the tool launched K1 {res.k1_launches} and K1' "
             f"{res.k1_rev_launches} times")
    if not np.array_equal(res.single_counts, res.sharded_counts):
        n_bad = int((res.single_counts != res.sharded_counts).sum())
        fail(f"the one-device and the 1 x 1 sharded step's counts differ in "
             f"{n_bad} entries")
    if int(res.single_counts.sum()) <= 0:
        fail("the tool's steps counted no support")
    if not np.isfinite(line["sharding_overhead_x"]):
        fail(f"sharding_overhead_x is {line['sharding_overhead_x']}")
    log(f"[scaling] {P} problems of bucket 2048; one-device and 1 x 1 "
        f"sharded step counts exact, sum {int(res.single_counts.sum())}; K1 "
        f"launches {res.k1_launches}, K1' {res.k1_rev_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return res.k1_launches, res.k1_rev_launches


# ---- phase 10 -----------------------------------------------------------------


def _times(line: dict, prefix: str = ""):
    """(key, value) of every float of a profile's line, nested or not."""
    for key, val in line.items():
        if isinstance(val, dict):
            yield from _times(val, f"{prefix}{key}.")
        elif isinstance(val, list):
            for i, row in enumerate(val):
                yield from _times(row, f"{prefix}{key}[{i}].")
        elif isinstance(val, float):
            yield prefix + key, val


def check_times(line: dict, what: str) -> None:
    bad = [(k, v) for k, v in _times(line) if not (np.isfinite(v) and v > 0)]
    if bad:
        fail(f"{what}: times not finite and positive: {bad}")


def split_of(row: dict) -> str:
    return ", ".join(
        f"{k} {row[k] * 1e3:.3f} ms" for k in ("upload", "dispatch", "fetch",
                                                "chain5", "suppress")
    ) + f", D1 {row['d1_ms']:.3f} ms"


def phase_seed_profile(paths, n_reads: int) -> int:
    """Phase 10: the seed profilers on phase 3's bundle on cuda:0; returns
    profile_seed5's D1 launches."""
    import torch

    from svjedi_tpu_torch import profile_seed, profile_seed5

    dev = torch.device("cuda:0")
    bundle = (paths["ref"], paths["vcf"], paths["reads"])
    d1_launches = 0
    for n in (4096, 16384):
        t0 = time.perf_counter()
        res = profile_seed5.measure(*bundle, dev, n_reads=n)
        line = res.line
        what = f"profile_seed5 on {n} reads"
        log(f"[seed] {what}: {json.dumps(line)}")
        iters = len(line["iters"])
        if line["n_reads"] != min(n, n_reads) or line["device"] != str(dev):
            fail(f"{what} profiled {line['n_reads']} reads on "
                 f"{line['device']}")
        if res.d1_launches < iters:
            fail(f"{what} launched D1 {res.d1_launches} times in {iters} "
                 f"scan iterations")
        if not len(res.host_cands):
            fail(f"{what} found no candidate")
        diff = profile_seed5.differing_fields(res.device_cands,
                                              res.host_cands)
        if diff:
            fail(f"{what}: device-scan candidates differ from the host "
                 f"scan's in {diff}")
        check_times(line, what)
        log(f"[seed] {n} reads: cold {split_of(line['cold'])}; warm (best "
            f"of {iters - 1}) {split_of(line['warm'])}; n_cands "
            f"{line['cold']['n_cands']} = host scan's "
            f"{line['n_cands_host_scan']}, all fields equal")
        log(f"[seed] {n} reads: merge_indexes "
            f"{line['merge_indexes_s'] * 1e3:.1f} ms, lazy builds: "
            f"native_lookup {line['lookup_prebuild_s'] * 1e3:.1f} ms, "
            f"hash_bitmap {line['bitmap_build_s'] * 1e3:.1f} ms, "
            f"packed_hits {line['packed_hits_build_s'] * 1e3:.1f} ms; "
            f"stream's first chunk {line['stream_first_chunk_s'] * 1e3:.1f}"
            f" ms; chain5 by threads " + ", ".join(
                f"{t} {line[f'chain5_threads_{t}'] * 1e3:.1f} ms"
                for t in profile_seed5.THREADS)
            + f"; host scan + chain {line['host_scan_chain'] * 1e3:.1f} ms;"
            f" D1 launches {res.d1_launches}; "
            f"{time.perf_counter() - t0:.1f} s")
        d1_launches += res.d1_launches
    t0 = time.perf_counter()
    res = profile_seed.measure(*bundle, dev, reps=1)
    line = res.line
    log(f"[seed] profile_seed: {json.dumps(line)}")
    if line["reads"] != n_reads:
        fail(f"profile_seed profiled {line['reads']} reads, not {n_reads}")
    if not all(t["kept"] > 0 and t["blocks"] > 0 for t in line["trials"]) \
            or not all(f["n_panel"] > 0 for f in line["full"]):
        fail("profile_seed found no minimizer, block or panel candidate")
    check_times(line, "profile_seed")
    best = {k: min(t[k] for t in line["trials"])
            for k in ("scan_bitmap", "chain2", "scan_raw")}
    log(f"[seed] profile_seed, {n_reads} reads (best of 3): scan + bitmap "
        f"{best['scan_bitmap'] * 1e3:.1f} ms, chain2 "
        f"{best['chain2'] * 1e3:.1f} ms, raw scan "
        f"{best['scan_raw'] * 1e3:.1f} ms; full seed "
        f"{min(f['seed_candidates'] for f in line['full']) * 1e3:.1f} ms + "
        f"suppress {min(f['suppress'] for f in line['full']) * 1e3:.1f} ms;"
        f" {time.perf_counter() - t0:.1f} s")
    return d1_launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    sys.path.insert(0, str(ROOT))
    try:
        import torch  # noqa: F401

        import svjedi_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from the repository root")

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - t_start:.1f} s)")
        return out

    peak_ops = timed("1", phase_device)
    kern = timed("2", phase_kernel, peak_ops)
    onepass_err, onepass_ms, onepass_bound, prod = timed(
        "2b", phase_onepass_kernels, peak_ops)
    k4_launches = timed("2c", phase_pregathered_path, *prod)
    del prod  # phase 4 reads the card's peak memory: free phase 2b's buffers
    gather_kern = timed("2f", phase_gather_kernel, peak_ops)

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_", dir=str(ROOT)) as tmp:
        paths, n_reads = timed("simulate", simulate_bundle, Path(tmp), 10,
                               1000, 20.0)
        genome = timed("genome", build_genome, paths)
        scan = timed("2d", phase_dev_scan, peak_ops, paths, genome)
        stats_kern = timed("2e", phase_stats_kernel, peak_ops, paths, genome)
        del genome
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        launches, rev_launches, scan_launches, stats3, v3_prefix = timed(
            "3", phase_main_path, Path(tmp), paths, n_reads)
        phase3_wall = time.perf_counter() - t3
        dma_launches, stats4 = timed("4", phase_onepass_path, Path(tmp),
                                     paths, n_reads, v3_prefix, "dma")
        g1_launches, stats4b = timed("4b", phase_onepass_path, Path(tmp),
                                     paths, n_reads, v3_prefix, "gather")
        timed("5", phase_bench, Path(tmp))
        step_fwd, step_rev, step_g1 = timed("6", phase_dist_step, paths)
        run_fwd, run_rev, stats6 = timed("6 run", phase_dist_run, Path(tmp),
                                         paths, v3_prefix)
        stats7 = timed("7", phase_multihost_any, Path(tmp), paths, v3_prefix,
                       t_start, phase3_wall)
        torch.cuda.empty_cache()
        modes = timed("8", phase_modes_any, Path(tmp), paths, v3_prefix,
                      t_start, phase3_wall)
        torch.cuda.empty_cache()
        scaling_fwd, scaling_rev = timed("9", phase_scaling, paths)
        seed_d1 = timed("10", phase_seed_profile, paths, n_reads)

    # Each kernel's launches in the JSON line are those of its own path's
    # run (K1, K1', D1 and A1's fused-fetch entry: phase 3, `run`; K3:
    # phase 4; K4: phase 2c; G1: phase 4b; A1's pre-gathered entry: phase
    # 2e's host-path audit); the other paths' counts, each gated > 0 in its
    # phase, are logged here.
    log(f"[kernels] launches of the other paths: K1 sharded step {step_fwd}, "
        f"--data-shards/--graph-shards run {run_fwd}; K1' {step_rev}, "
        f"{run_rev}; A1 dma path {stats4}, gather path {stats4b}, "
        f"--data-shards/--graph-shards run {stats6}, --multihost {stats7}; "
        f"G1 xla count step {step_g1}")
    log("[kernels] launches of phase 8's modes: " + "; ".join(
        f"{mode}: " + ", ".join(f"{k} {n}" for k, n in launches.items())
        for mode, launches in modes.items()))
    log(f"[kernels] launches of phase 9 (bench_scaling, both steps): K1 "
        f"{scaling_fwd}, K1' {scaling_rev}")
    log(f"[kernels] launches of phase 10 (profile_seed5 at 4,096 and 16,384 "
        f"reads): D1 {seed_d1}")
    source = "svjedi_tpu_torch/kernels/csrc/band_dp_onepass.cu"
    v3_source = "svjedi_tpu_torch/kernels/csrc/band_dp_v3.cu"
    print(json.dumps({"kernels": [{
        "name": "band_dp_v3_fwd",
        "route": "cuda",
        "source": v3_source,
        "replaces": "svjedi_tpu/kernels/band_dp_v3.py:53",
        "launches": launches - rev_launches,
        "library_ms": None,
        **kern["fwd"],
    }, {
        "name": "band_dp_v3_rev",
        "route": "cuda",
        "source": v3_source,
        "replaces": "svjedi_tpu/kernels/band_dp_v3.py:368",
        "launches": rev_launches,
        "library_ms": None,
        **kern["rev"],
    }, {
        "name": "band_dp_dma",
        "route": "cuda",
        "source": source,
        "replaces": "svjedi_tpu/kernels/band_dp_dma.py:64",
        "launches": dma_launches,
        "max_abs_err": onepass_err["k3"],
        "ms": onepass_ms["k3"][0],
        "plain_ms": onepass_ms["k3"][1],
        "bound_ms": onepass_bound["k3"][0],
        "bound_by": onepass_bound["k3"][1],
        "library_ms": None,
    }, {
        "name": "band_dp_onepass",
        "route": "cuda",
        "source": source,
        "replaces": "svjedi_tpu/kernels/band_dp.py:53",
        "launches": k4_launches,
        "max_abs_err": onepass_err["k4"],
        "ms": onepass_ms["k4"][0],
        "plain_ms": onepass_ms["k4"][1],
        "bound_ms": onepass_bound["k4"][0],
        "bound_by": onepass_bound["k4"][1],
        "library_ms": None,
    }, {
        "name": "dev_scan",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/dev_scan.cu",
        "replaces": "svjedi_tpu/align/dev_scan.py:62",
        "launches": scan_launches,
        "library_ms": None,
        **scan,
    }, {
        "name": "band_dp_stats",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/band_dp_stats.cu",
        "replaces": "svjedi_tpu/align/extend.py:188",
        "library_ms": None,
        **stats_kern["gathered"],
    }, {
        "name": "band_dp_stats_flat",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/band_dp_stats.cu",
        "replaces": "svjedi_tpu/align/extend.py:188",
        "library_ms": None,
        **stats_kern["flat"],
        "launches": stats3,
    }, {
        "name": "band_dp_gather",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/band_dp_gather.cu",
        "replaces": "svjedi_tpu/align/extend.py:65",
        "launches": g1_launches,
        "library_ms": None,
        **gather_kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
