"""Benchmark of the port: align-stage throughput (reads/s) on one card.

    python -m svjedi_tpu_torch.bench [--device {cuda,cpu}]

The counterpart of the JAX package's ``bench.py``, run with this package's
own modules. Output: exactly ONE JSON line
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}`` on stdout;
the ``[scale]`` and ``[bench] pass...`` lines, each pass's ``timings``
(``seed_s``, ``seed_cpu_s``, ``dp_s``, ...) and the seed path go to stderr.
It runs on ``cuda:0`` and refuses to run without a card unless given
``--device cpu``.

Configurations (``SVJT_BENCH_CONFIG``):

- ``golden`` (default): the reference test-dir bundle in ``SVJT_TESTDIR``
  (``test.vcf``, ``reference_genome.fasta``, ``simulated_reads.fastq.gz``,
  ``expected_genotype.vcf.eval``) replicated ``SVJT_BENCH_REPS`` times;
  a warm pass must reproduce the golden ``.eval``; the metric
  ``reads_per_s_per_chip`` is the best of the passes after the first of
  ``SVJT_BENCH_PASSES`` (chunks of ``SVJT_BENCH_CHUNK_READS`` reads,
  flushes every ``SVJT_BENCH_FLUSH_EVERY`` chunks). Without the bundle it
  prints the error line and exits 1.
- ``scale``: a simulated genome (``SVJT_SCALE_MB`` Mb over
  ``SVJT_SCALE_CHROMS`` chromosomes, ``SVJT_SCALE_SVS`` SVs of
  ``SVJT_SCALE_TYPES``, ``SVJT_SCALE_COV``x of reads; seeds 2 and 11),
  decoy on; a warm pass gated at ``SVJT_SCALE_MIN_ACC`` accuracy against
  the truth, then a timed pass (or, with ``SVJT_SCALE_ONE_PASS=1``, the
  warm pass timed); the metric is ``scale_reads_per_s_per_chip``. With
  ``SVJT_SCALE_MEMLOG=/path.tsv`` a sampler thread writes the JAX bench's
  phase-tagged memory profile there (:class:`MemLog`).

Both passes run ``align_and_count`` with ``collect_audit=False``: they time
seeding (the device minimizer scan where it runs), the DP kernels and
counting. ``vs_baseline`` divides by ``SVJT_BASELINE_READS_PER_S`` (500, the
JAX bench's minigraph-class CPU figure).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

BASELINE_READS_PER_S = float(os.environ.get("SVJT_BASELINE_READS_PER_S", "500"))
CONFIG = os.environ.get("SVJT_BENCH_CONFIG", "golden")
GOLDEN_FILES = ("test.vcf", "reference_genome.fasta",
                "simulated_reads.fastq.gz", "expected_genotype.vcf.eval")


def _result(metric: str, reads_per_s: float, **extra) -> str:
    return json.dumps({
        "metric": metric,
        "value": round(reads_per_s, 2),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        **extra,
    })


def _log_pass(tag: str, timings: dict, seed_path: str) -> None:
    print(f"[bench] {tag} seed_path={seed_path} "
          + " ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in timings.items()),
          file=sys.stderr)


def _build_decoy(panel, cfg):
    """Whole-genome decoy index, exactly as run_pipeline builds it."""
    if not cfg.decoy:
        return None
    from .align.decoy import build_decoy

    return build_decoy(panel, k=cfg.kmer, w=cfg.window,
                       max_hits_per_minimizer=cfg.max_hits_per_minimizer)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cur_rss_gb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return 0.0


#: The labels of the scale bench's phases, in the order it sets them.
MEMLOG_PHASES = ("start", "sim", "sim_reads", "graph", "panel", "index",
                 "decoy", "align_warm", "align_timed")


class MemLog:
    """The ``SVJT_SCALE_MEMLOG`` profile: current RSS against the active phase.

    Given a path, a sampler thread writes the JAX bench's tab-separated
    header ``t_s rss_gb phase`` and then, every 0.5 s, the seconds since
    it started (one decimal), the current RSS (``VmRSS``, GB, two
    decimals) and the active phase label. :meth:`enter` also writes a row
    at once, so that a phase shorter than the period still shows.
    :meth:`stop` ends the sampling (the JAX sampler runs until the process
    exits), joins the thread and closes the file. Without a path nothing
    is written and no thread starts.
    """

    PERIOD_S = 0.5

    def __init__(self, path=None):
        self._phase = MEMLOG_PHASES[0]
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._fh = None
        self._thread = None
        if path:
            self._fh = open(path, "w")
            self._t0 = time.perf_counter()
            self._fh.write("t_s\trss_gb\tphase\n")
            self._thread = threading.Thread(target=self._sample,
                                            name="svjt-scale-memlog",
                                            daemon=True)
            self._thread.start()

    def enter(self, label: str) -> None:
        """Make ``label`` the active phase."""
        self._phase = label
        self._row()

    def _row(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.write(f"{time.perf_counter() - self._t0:.1f}\t"
                               f"{_cur_rss_gb():.2f}\t{self._phase}\n")
                self._fh.flush()

    def _sample(self) -> None:
        while True:
            self._row()
            if self._stopped.wait(self.PERIOD_S):
                return

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._fh is not None:
            with self._lock:
                self._fh.close()


def scale_bench(device: torch.device) -> int:
    """Throughput on the simulated scale configuration."""
    memlog = MemLog(os.environ.get("SVJT_SCALE_MEMLOG"))
    try:
        return _scale_bench(device, memlog)
    finally:
        memlog.stop()


def _scale_bench(device: torch.device, memlog: MemLog) -> int:
    from .align.index import build_panel_index
    from .align.pipeline import align_and_count, use_device_scan
    from .config import AlignConfig, GenotypeConfig
    from .evals.contingency import contingency_report
    from .genotype.vcf_writer import write_genotyped_vcf
    from .graph.build import build_graph
    from .graph.cluster import build_panel
    from .graph.svparse import parse_vcf_svs
    from .io import sim
    from .io.fastq import ReadStream

    mb = int(os.environ.get("SVJT_SCALE_MB", "10"))
    n_svs = int(os.environ.get("SVJT_SCALE_SVS", "1000"))
    cov = float(os.environ.get("SVJT_SCALE_COV", "20"))
    n_chroms = int(os.environ.get("SVJT_SCALE_CHROMS", "1"))
    sv_types = tuple(os.environ.get("SVJT_SCALE_TYPES", "DEL,INS,INV").split(","))
    min_acc = float(os.environ.get("SVJT_SCALE_MIN_ACC", "100.0"))
    one_pass = os.environ.get("SVJT_SCALE_ONE_PASS", "0") == "1"
    per = mb * 1_000_000 // n_chroms
    rng = np.random.default_rng(11)
    memlog.enter("sim")
    s = sim.simulate(
        seed=2, chrom_lengths={f"chr{i + 1}": per for i in range(n_chroms)},
        n_svs=n_svs, sv_types=sv_types,
    )
    cfg = AlignConfig()
    gcfg = GenotypeConfig()
    seed_path = "device" if use_device_scan(cfg) else "host"
    with tempfile.TemporaryDirectory() as tmp:
        reads_path = os.path.join(tmp, "reads.fastq")
        memlog.enter("sim_reads")
        n_reads, n_bases = sim.simulate_reads_fastq(rng, s.haplotypes,
                                                    coverage=cov,
                                                    path=reads_path)
        vcf = os.path.join(tmp, "t.vcf")
        sim.write_truth_vcf(s, vcf)
        parsed = parse_vcf_svs(vcf, {c: len(x) for c, x in s.chroms.items()})
        memlog.enter("graph")
        graph = build_graph(s.chroms, parsed)
        memlog.enter("panel")
        panel = build_panel(graph, flank=cfg.flank,
                            cluster_gap=cfg.cluster_gap,
                            max_paths_per_cluster=cfg.max_paths_per_cluster)
        memlog.enter("index")
        index = build_panel_index(
            panel, k=cfg.kmer, w=cfg.window,
            max_hits_per_minimizer=cfg.max_hits_per_minimizer)
        memlog.enter("decoy")
        decoy = _build_decoy(panel, cfg)
        s = None  # the haplotypes are on disk as reads now
        pre_align_resident_gb = _cur_rss_gb()

        def timed_pass():
            timings: dict = {}
            t0 = time.perf_counter()
            counts, _, _ = align_and_count(
                ReadStream(reads_path), panel, index, cfg, gcfg,
                device=device, collect_audit=False, timings=timings,
                decoy=decoy,
            )
            _sync(device)
            return counts, time.perf_counter() - t0, timings

        memlog.enter("align_warm")
        counts, dt, timings = timed_pass()  # warm + correctness input
        if one_pass:
            memlog.stop()
        _log_pass(f"warm reads={n_reads} total={dt:.2f}s", timings, seed_path)
        out_vcf = os.path.join(tmp, "g.vcf")
        write_genotyped_vcf(vcf, out_vcf, counts)
        report = contingency_report(vcf, out_vcf)
        acc = re.search(r"accuracy: ([\d.]+)", report)
        if acc is None or float(acc.group(1)) < min_acc:
            print(" | ".join(report.strip().splitlines()), file=sys.stderr)
            print(_result("scale_reads_per_s_per_chip", 0.0,
                          error="scale accuracy check failed"))
            return 1
        if not one_pass:
            memlog.enter("align_timed")
            _, dt, timings = timed_pass()
            memlog.stop()
            _log_pass(f"timed reads={n_reads} total={dt:.2f}s", timings,
                      seed_path)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(
        f"[scale] genome={mb}Mb chroms={n_chroms} "
        f"types={','.join(sv_types)} svs={n_svs} cov={cov} "
        f"reads={n_reads} read_bases={int(n_bases / 1e6)}Mb "
        f"panel_paths={len(panel.paths)} "
        f"panel_bases={sum(p.length for p in panel.paths) / 1e6:.1f}Mb "
        f"decoy_hits={len(decoy.index.hit_path) if decoy else 0} "
        f"accuracy={acc.group(1)} align_s={dt:.3f} "
        f"peak_host_rss_gb={peak_gb:.1f} "
        f"pre_align_resident_gb={pre_align_resident_gb:.1f} "
        f"post_align_resident_gb={_cur_rss_gb():.1f} "
        f"device={_device_name(device)}",
        file=sys.stderr,
    )
    print(_result("scale_reads_per_s_per_chip", n_reads / dt))
    return 0


def tile_reads(base, reps: int):
    """The reads of ``base`` repeated ``reps`` times, renamed
    ``name/rep``."""
    from .io.fastq import ReadSet

    return ReadSet(
        names=[f"{n}/{r}" for r in range(reps) for n in base.names],
        codes=np.tile(base.codes, reps),
        offsets=np.concatenate(
            [base.offsets[:-1] + r * base.codes.size for r in range(reps)]
            + [np.array([base.codes.size * reps])]
        ),
    )


def golden_bench(device: torch.device, test_dir) -> int:
    """Throughput on the replicated golden bundle in ``test_dir`` (None:
    not given), gated on its .eval."""
    from .align.index import build_panel_index
    from .align.pipeline import align_and_count, use_device_scan
    from .config import AlignConfig, GenotypeConfig
    from .evals.contingency import contingency_report
    from .genotype.vcf_writer import write_genotyped_vcf
    from .graph.build import build_graph
    from .graph.cluster import build_panel
    from .graph.svparse import parse_vcf_svs
    from .io.fasta import read_fasta
    from .io.fastq import read_reads

    if test_dir is None:
        print(_result("reads_per_s_per_chip", 0.0,
                      error="no golden test-dir: set SVJT_TESTDIR"))
        return 1
    test_dir = Path(test_dir)
    missing = [f for f in GOLDEN_FILES if not (test_dir / f).is_file()]
    if missing:
        print(_result("reads_per_s_per_chip", 0.0,
                      error=f"golden test-dir {test_dir} lacks "
                            f"{', '.join(missing)}"))
        return 1
    reps_n = int(os.environ.get("SVJT_BENCH_REPS", "10"))
    n_passes = int(os.environ.get("SVJT_BENCH_PASSES", "8"))
    chunk_reads = int(os.environ.get("SVJT_BENCH_CHUNK_READS", "2048"))
    flush_every = int(os.environ.get("SVJT_BENCH_FLUSH_EVERY", "2"))
    align_cfg = AlignConfig()
    genotype_cfg = GenotypeConfig()
    seed_path = "device" if use_device_scan(align_cfg) else "host"

    chroms = read_fasta(test_dir / "reference_genome.fasta")
    parsed = parse_vcf_svs(test_dir / "test.vcf",
                           {c: len(s) for c, s in chroms.items()})
    panel = build_panel(build_graph(chroms, parsed), flank=align_cfg.flank,
                        cluster_gap=align_cfg.cluster_gap,
                        max_paths_per_cluster=align_cfg.max_paths_per_cluster)
    index = build_panel_index(
        panel, k=align_cfg.kmer, w=align_cfg.window,
        max_hits_per_minimizer=align_cfg.max_hits_per_minimizer)
    decoy = _build_decoy(panel, align_cfg)
    base = read_reads(str(test_dir / "simulated_reads.fastq.gz"))

    counts, _, _ = align_and_count(
        base, panel, index, align_cfg, genotype_cfg, device=device,
        collect_audit=False, decoy=decoy,
    )
    with tempfile.TemporaryDirectory() as tmp:
        out_vcf = Path(tmp) / "g.vcf"
        write_genotyped_vcf(test_dir / "test.vcf", out_vcf, counts)
        report = contingency_report(test_dir / "test.vcf", out_vcf)
    if report != (test_dir / "expected_genotype.vcf.eval").read_text():
        print(_result("reads_per_s_per_chip", 0.0,
                      error="golden genotype check failed"))
        return 1

    reps = tile_reads(base, reps_n)
    # Pass 0 warms every shape and host buffer; the metric is the best of
    # the later passes.
    dt = None
    for pass_i in range(n_passes):
        timings: dict = {}
        t0 = time.perf_counter()
        align_and_count(reps, panel, index, align_cfg, genotype_cfg,
                        device=device, collect_audit=False, timings=timings,
                        decoy=decoy, chunk_reads=chunk_reads,
                        flush_every=flush_every)
        _sync(device)
        pass_dt = time.perf_counter() - t0
        if pass_i > 0:
            dt = pass_dt if dt is None else min(dt, pass_dt)
        _log_pass(f"pass{pass_i} reads={reps.n_reads} total={pass_dt:.2f}s",
                  timings, seed_path)
    if dt is None:
        print(_result("reads_per_s_per_chip", 0.0,
                      error="SVJT_BENCH_PASSES must be at least 2"))
        return 1
    print(_result("reads_per_s_per_chip", reps.n_reads / dt))
    return 0


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "_")
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m svjedi_tpu_torch.bench",
        description="Align-stage throughput of the PyTorch port.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; refuses without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from .pipeline import select_device

        device = select_device()
    else:
        device = torch.device("cpu")
    from .kernels import build

    build.build_native()
    if CONFIG == "scale":
        return scale_bench(device)
    return golden_bench(device, os.environ.get("SVJT_TESTDIR"))


if __name__ == "__main__":
    raise SystemExit(main())
