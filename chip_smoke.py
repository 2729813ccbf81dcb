#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught and continued):

1. Device: a CUDA device must be visible; prints its name and the
   ``nvidia-smi`` name and power limit, then builds the CUDA kernels
   (``svjedi_tpu_torch/kernels/csrc``) and the native host library.
2. Kernel vs plain: the band_dp_v3 kernel against its plain PyTorch version
   on the same CUDA tensors, exactly, at every bucket of
   ``AlignConfig.buckets`` (P = 256), at a production-shaped batch
   (P = 32768, bucket 2048), with and without row bounds, with
   ``n_valid < P`` and on edge cases; the reverse pass and the two-pass
   wrapper likewise. Times the kernel and the plain version at
   P = 32768, bucket 2048.
3. Main path: simulates the 10 Mb / 1,000 SV / 20x configuration
   (``bench.py``'s scale config seeds) and runs
   ``python -m svjedi_tpu_torch run`` on it as a subprocess. It must exit 0,
   genotype at accuracy 100.0, launch the kernel, and print none of the
   aligner's fault warnings.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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

    from svjedi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    log(f"[build] CUDA kernels: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s) -> "
        f"{build.library_path().relative_to(ROOT)}")
    so = ROOT / "native" / "libsvtfastio.so"
    t0 = time.perf_counter()
    if not so.exists():
        proc = subprocess.run(
            ["make", "-C", str(ROOT / "native")], capture_output=True,
            text=True, timeout=600,
        )
        if proc.returncode != 0 or not so.exists():
            fail(f"native library build failed:\n{proc.stdout}{proc.stderr}")
    log(f"[build] native host library: {time.perf_counter() - t0:.2f} s")


# ---- phase 2 ----------------------------------------------------------------


def make_problems(seed: int, P: int, bucket: int, sort_m: bool = False):
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
    t = np.full((P, bucket + BAND), 4, dtype=np.int8)
    off = rng.integers(0, BAND, size=P)
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


def cuda_time_ms(fn, reps: int) -> float:
    import torch

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


def phase_kernel():
    import torch

    from svjedi_tpu.config import AlignConfig
    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.kernels import band_dp_v3 as v3

    dev = torch.device("cuda:0")
    params = DPParams()
    max_err = 0
    n_cases = 0

    def compare(what, got, ref):
        nonlocal max_err, n_cases
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        n_cases += 1
        if err != 0:
            fail(f"kernel disagrees with the plain version: {what} "
                 f"(max abs err {err})")

    def fwd_case(tag, qT, tT, bucket, n_valid):
        got = v3.band_dp_v3_fwd(qT, tT, bucket, BAND, params, n_valid)
        ref = v3.band_dp_v3_fwd_ref(qT, tT, bucket, BAND, params, n_valid)
        compare(f"fwd {tag}", got, ref)
        return got

    buckets = list(AlignConfig().buckets)
    for bucket in buckets:
        P = 256
        qT, tT, m = make_problems(bucket, P, bucket, sort_m=True)
        qT, tT = torch.from_numpy(qT).to(dev), torch.from_numpy(tT).to(dev)
        bounds = m.reshape(-1, 128).max(axis=1)
        t0 = time.perf_counter()
        fwd_case(f"bucket={bucket} unbounded", qT, tT, bucket, None)
        nvb = torch.tensor(np.concatenate([[P - 37], bounds]),
                           dtype=torch.int32, device=dev)
        fwd_case(f"bucket={bucket} bounds n_valid={P - 37}", qT, tT, bucket, nvb)
        got = v3.band_dp_v3(qT, tT, bucket, BAND, params)
        ref = v3.band_dp_v3(qT, tT, bucket, BAND, params,
                            fwd=v3.band_dp_v3_fwd_ref)
        for key in got:
            compare(f"two-pass {key} bucket={bucket}", got[key], ref[key])
        compare(f"score_rev == score bucket={bucket}", got["score_rev"],
                got["score"])
        rev = v3.band_dp_v3_rev(qT, tT, bucket, BAND, params, n_valid=200)
        rev_ref = v3.band_dp_v3_rev(qT, tT, bucket, BAND, params, n_valid=200,
                                    fwd=v3.band_dp_v3_fwd_ref)
        compare(f"rev bucket={bucket}", rev[:200], rev_ref[:200])
        log(f"[kernel] bucket {bucket:5d} P {P}: fwd, bounded fwd, rev, "
            f"two-pass exact ({time.perf_counter() - t0:.1f} s)")

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
    ref = v3.band_dp_v3(qT, tT, bucket, BAND, params, fwd=v3.band_dp_v3_fwd_ref)
    for key in got:
        compare(f"two-pass {key} P=32768", got[key], ref[key])
    log(f"[kernel] P 32768 bucket 2048: fwd, bounded fwd, two-pass exact; "
        f"{n_cases} comparisons, max abs err {max_err}")

    ms = cuda_time_ms(
        lambda: v3.band_dp_v3_fwd(qT, tT, bucket, BAND, params, nvb), reps=10
    )
    plain_ms = cuda_time_ms(
        lambda: v3.band_dp_v3_fwd_ref(qT, tT, bucket, BAND, params, nvb),
        reps=2,
    )
    cells = float(bounds.clip(max=bucket).sum()) * 128 * BAND
    log(f"[kernel] band_dp_v3_fwd P 32768 bucket 2048 (row bounds): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {cells / ms / 1e6:.2f} "
        f"Gcell/s kernel")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


# ---- phase 3 ----------------------------------------------------------------


def simulate_bundle(out: Path, mb: int, n_svs: int, cov: float):
    """The scale configuration of bench.py: seeds 2 (genome) and 11 (reads)."""
    from svjedi_tpu.io import sim
    from svjedi_tpu.io.fasta import write_fasta

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


def phase_main_path(out: Path, mb: int = 10, n_svs: int = 1000,
                    cov: float = 20.0, timeout: int = 900):
    from svjedi_tpu.evals.contingency import contingency_report
    from svjedi_tpu_torch.kernels import band_dp_v3

    paths, n_reads = simulate_bundle(out, mb, n_svs, cov)
    prefix = out / "run"
    cmd = [
        sys.executable, "-m", "svjedi_tpu_torch", "run",
        "-v", str(paths["vcf"]), "-r", str(paths["ref"]),
        "-q", str(paths["reads"]), "-p", str(prefix),
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
    if launches <= 0:
        fail("the main path launched the band_dp_v3 kernel no time")
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
        f"bytes; band_dp_v3 launches {launches}; seed path "
        f"{counters.get('seed_path')}; audit re-score warnings {n_audit_warn}; "
        f"n_audit_rescore_below {counters.get('n_audit_rescore_below')}")
    return launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    sys.path.insert(0, str(ROOT))
    try:
        import torch  # noqa: F401

        import svjedi_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from the repository root")

    phase_device()
    kern = phase_kernel()
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_", dir=str(ROOT)) as tmp:
        launches = phase_main_path(Path(tmp))

    import torch

    print(json.dumps({"kernels": [{
        "name": "band_dp_v3_fwd",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/band_dp_v3.cu",
        "replaces": "svjedi_tpu/kernels/band_dp_v3.py:53",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
