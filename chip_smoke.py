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
2b. One-pass kernels vs plain, exactly, at every bucket with band 128 and
   at bucket 2048 with band 256 (P = 256): the pre-gathered entry
   (``band_dp_onepass``, the same edge cases) and the fused-fetch entry
   (``band_dp_dma_raw``) on real upload buffers (forward and reverse-strand
   windows, windows crossing the path bounds, m < bucket, padding rows with
   m = 0); both at P = 32768, bucket 2048, timed against their plain
   versions.
2c. Pre-gathered path: the windows of phase 2b's production batch fetched
   on the card (``gather_windows``) and scored by ``band_dp_onepass``; the
   result must equal the fused-fetch kernel's on the same problems.
3. Main path: simulates the 10 Mb / 1,000 SV / 20x configuration
   (``bench.py``'s scale config seeds) and runs
   ``python -m svjedi_tpu_torch run`` on it as a subprocess (the v3
   engine, with ``--gaf``). It must exit 0, genotype at accuracy 100.0,
   launch the kernel, and print none of the aligner's fault warnings.
4. One-pass path: ``run_pipeline(..., engine="dma")`` in this process on
   phase 3's files, gated like phase 3, with band_dp_dma launches > 0 and
   band_dp_v3 launches == 0; prints its align stage, reads/s, peak device
   memory, the VCF records that differ from phase 3's, and per winner field
   (GAF spans, score, mapq) how many winners the two engines disagree on.

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


def phase_main_path(out: Path, paths, n_reads, timeout: int = 900):
    from svjedi_tpu.evals.contingency import contingency_report
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
    return launches, prefix


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


def phase_onepass_kernels():
    """K4 (pre-gathered) and K3 (fused fetch) against their plain versions."""
    import torch

    from svjedi_tpu.config import AlignConfig
    from svjedi_tpu_torch.align.extend import DPParams
    from svjedi_tpu_torch.kernels import band_dp as k4
    from svjedi_tpu_torch.kernels import band_dp_dma as k3

    dev = torch.device("cuda:0")
    params = DPParams()
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

    def k4_case(tag, q, t, band=BAND):
        got = k4.band_dp_onepass(q, t, band, params)
        ref = k4.band_dp_onepass_ref(q, t, band, params)
        for key in got:
            compare("k4", f"{key} {tag}", got[key], ref[key])

    def k3_case(tag, data, vecs, bucket, band=BAND):
        got = k3.band_dp_dma_raw(data.reads2, data.panel_padded, *vecs,
                                 bucket=bucket, band=band, params=params)
        ref = k3.band_dp_dma_raw_ref(data.reads2, data.panel_padded, *vecs,
                                     bucket=bucket, band=band, params=params)
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
        del data, vecs
        log(f"[onepass] bucket {bucket:5d} band {band} P 256: band_dp_onepass "
            f"and band_dp_dma exact ({time.perf_counter() - t0:.1f} s)")

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
        plain_ms = cuda_time_ms(plain, reps=1)
        times[name] = (ms, plain_ms)
        log(f"[onepass] {name.upper()} P 32768 bucket 2048: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
    return err, times, (data, vecs, dma_out, bucket)


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


def compare_winners(ours: Path, theirs: Path) -> str:
    """Per field, how many winners two runs' GAF files disagree on."""
    a, b = gaf_winners(ours), gaf_winners(theirs)
    both = a.keys() & b.keys()
    fields = ("qs", "qe", "ts", "te", "matches", "mapq")
    diff = {k: sum(a[w][k] != b[w][k] for w in both) for k in fields}
    return (f"{len(both)} winners in both, {len(a.keys() - b.keys())} only "
            f"in dma, {len(b.keys() - a.keys())} only in v3; differing: "
            + ", ".join(f"{k} {v}" for k, v in diff.items()))


def phase_onepass_path(out: Path, paths, n_reads, v3_prefix: Path):
    """The one-pass engine (fused-fetch kernel) through run_pipeline."""
    import contextlib
    import io

    import torch

    from svjedi_tpu.config import PipelineConfig
    from svjedi_tpu.evals.contingency import contingency_report
    from svjedi_tpu_torch.kernels import band_dp_dma, band_dp_v3
    from svjedi_tpu_torch.pipeline import run_pipeline

    prefix = out / "dma"
    cfg = PipelineConfig(vcf=paths["vcf"], ref=paths["ref"],
                         reads=(str(paths["reads"]),), prefix=str(prefix),
                         write_gaf=True)
    err = io.StringIO()
    band_dp_dma.launches = 0
    band_dp_v3.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        run_pipeline(cfg, device=torch.device("cuda:0"), engine="dma")
    wall = time.perf_counter() - t0
    launches, v3_launches = band_dp_dma.launches, band_dp_v3.launches
    stderr = err.getvalue()
    for line in stderr.splitlines()[-8:]:
        log(f"[onepass-path] stderr: {line}")
    faults = [w for w in FAULT_WARNINGS if w in stderr]
    if faults:
        fail(f"fault warnings in the one-pass run: {faults}")
    if launches <= 0:
        fail("the one-pass path launched the band_dp_dma kernel no time")
    if v3_launches != 0:
        fail(f"the one-pass path launched the v3 kernel {v3_launches} times")
    with open(f"{prefix}_stats.json") as fh:
        stats = json.load(fh)
    counters, timings = stats["counters"], stats["timings_s"]
    if counters.get("engine") != "dma":
        fail(f"the one-pass run recorded engine {counters.get('engine')!r}")
    vcf = Path(f"{prefix}_genotype.vcf")
    report = contingency_report(paths["vcf"], str(vcf))
    acc = re.search(r"accuracy: ([\d.]+)", report)
    log("[onepass-path] " + " | ".join(report.strip().splitlines()))
    if acc is None or float(acc.group(1)) != 100.0:
        fail("one-pass genotyping accuracy is not 100.0")
    ours = vcf_records(vcf)
    theirs = vcf_records(Path(f"{v3_prefix}_genotype.vcf"))
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    n_diff = len(differ) + abs(len(ours) - len(theirs))
    for a, b in differ[:3]:  # engines may place tied optima differently
        fa, fb = a.split("\t"), b.split("\t")
        log(f"[onepass-path] differs at {fa[0]}:{fa[1]}: dma {fa[-1]} vs v3 "
            f"{fb[-1]}")
    # Engines agree on scores; among equally scoring optima each may pick
    # another span, and a span can move a read across a junction's rule.
    log("[onepass-path] winners (GAF) dma vs v3: "
        + compare_winners(Path(f"{prefix}.gaf"), Path(f"{v3_prefix}.gaf")))
    align_s = float(timings["align"])
    log(f"[onepass-path] run wall {wall:.1f} s; align stage {align_s:.2f} s, "
        f"{n_reads / align_s:.1f} reads/s; max_memory_allocated "
        f"{counters.get('device_max_memory_allocated')} bytes; band_dp_dma "
        f"launches {launches}; band_dp_v3 launches {v3_launches}; VCF records "
        f"differing from the v3 run: {n_diff} of {len(theirs)}; audit "
        f"re-score warnings {stderr.count(AUDIT_WARNING)}")
    return launches


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
    onepass_err, onepass_ms, prod = phase_onepass_kernels()
    k4_launches = phase_pregathered_path(*prod)
    del prod  # phase 4 reads the card's peak memory: free phase 2b's buffers

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_", dir=str(ROOT)) as tmp:
        paths, n_reads = simulate_bundle(Path(tmp), mb=10, n_svs=1000, cov=20.0)
        launches, v3_prefix = phase_main_path(Path(tmp), paths, n_reads)
        dma_launches = phase_onepass_path(Path(tmp), paths, n_reads, v3_prefix)

    source = "svjedi_tpu_torch/kernels/csrc/band_dp_onepass.cu"
    print(json.dumps({"kernels": [{
        "name": "band_dp_v3_fwd",
        "route": "cuda",
        "source": "svjedi_tpu_torch/kernels/csrc/band_dp_v3.cu",
        "replaces": "svjedi_tpu/kernels/band_dp_v3.py:53",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }, {
        "name": "band_dp_dma",
        "route": "cuda",
        "source": source,
        "replaces": "svjedi_tpu/kernels/band_dp_dma.py:64",
        "launches": dma_launches,
        "max_abs_err": onepass_err["k3"],
        "ms": onepass_ms["k3"][0],
        "plain_ms": onepass_ms["k3"][1],
    }, {
        "name": "band_dp_onepass",
        "route": "cuda",
        "source": source,
        "replaces": "svjedi_tpu/kernels/band_dp.py:53",
        "launches": k4_launches,
        "max_abs_err": onepass_err["k4"],
        "ms": onepass_ms["k4"][0],
        "plain_ms": onepass_ms["k4"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
