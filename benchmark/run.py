"""Benchmark of svjedi_tpu_torch: whole genotyping jobs on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``): build the port's libraries, make the cell's catalogue
and one sample (FASTQ under ``TMPDIR``) from the seed, build the catalogue's
graph, panel, index and decoy through the port as ``run_pipeline`` does,
and run one warm job. The window: whole jobs back to back until
``--seconds`` have passed, the last one finished. A job is ``run``'s
per-sample work: ``align_and_count`` on a fresh read stream of the sample
(audit on, decoy, default engine and chunking), then
``write_genotyped_vcf``. Every job's VCF and count table are judged against
the configuration's plain reference (``cell.reference``, by default
``reference.py``) once the window has closed. The catalogue and the sample
come from the configuration's generator (``cell.gen``, by default
``gen.py``); ``cells.py`` states what both provide.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``setup`` (set-up's parts), ``host`` (the process's CPU
seconds, which show whether a slow job waited or ran slower), and last
``checks``: each number compared with its limit. Without a card, or with fewer cards than
the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells as cellmod  # noqa: E402
from benchmark import devtrace  # noqa: E402

#: Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "svjedi_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared as a whole word."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Job:
    seconds: float
    ok: bool
    timings: dict = field(default_factory=dict)
    stream_s: float | None = None  # None: the stream was never pulled
    genotype_s: float = 0.0
    vcf: str = ""
    counts: dict = field(default_factory=dict)
    cpu_s: float = 0.0  # the process's CPU seconds, all its threads


class Probes:
    """The traced run's view into the program: a host span
    (``record_function``) around each step of the chunk loop, and the
    problems each kernel is handed, counted from their inputs with the
    frozen arithmetic of ``devtrace.py``:

    - K1 (v3 forward): the kept windows of ``align.pipeline.
      candidate_layout``, m rows x band cells at 9 ops;
    - K1' (v3 reverse): the winners without a start in ``align.pipeline.
      dispatch_rev``, m' = qe + 1 rows;
    - A1 (audit): the winners handed to ``align.pipeline.
      compute_winner_stats``, qe - qs + 1 rows in pieces of ``block_rows``
      at twice the band, 15 ops a cell;
    - D1 (scan): the chunk of ``align.dev_scan.dispatch_scan``,
      n_codes - k + 1 positions at 37 ops.
    """

    SPANS = ("dispatch_chunk", "collect_outs", "finalize_chunk",
             "collect_rev", "count_support", "prune_secondaries",
             "cross_cluster_prune")

    def __init__(self, align_cfg):
        self.cfg = align_cfg
        self.work = {k: [0.0, 0.0] for k in ("K1", "K1'", "A1", "D1")}
        self._saved = []

    def _add(self, kernel, ops, n_bytes):
        self.work[kernel][0] += float(ops)
        self.work[kernel][1] += float(n_bytes)

    def __enter__(self):
        import numpy as np
        from torch.profiler import record_function

        from svjedi_tpu_torch.align import dev_scan
        from svjedi_tpu_torch.align import device as dev
        from svjedi_tpu_torch.align import pipeline as ap

        B = self.cfg.band
        k1 = devtrace.OPS_PER_CELL["k1"]

        def layout(fn, *a, **k):
            out = fn(*a, **k)
            m = out[1][out[2]].astype(np.float64)
            self._add("K1", m.sum() * B * k1, 2 * m.sum() + (B + 12) * len(m))
            return out

        def rev(fn, cfg, disp, winners, win):
            if len(win) and disp.q_start is not None:
                need = np.flatnonzero(winners.qs == -1)
                m = (disp.qe_win[win[need]] + 1).astype(np.float64)
                self._add("K1'", m.sum() * B * k1,
                          2 * m.sum() + (B + 16) * len(m))
            return fn(cfg, disp, winners, win)

        def stats(fn, reads, panel, winners, cfg, *a, **k):
            span = (winners.qe - winners.qs + 1).astype(np.int64)
            span = span[span > 0]
            pieces = ((span + cfg.block_rows - 1) // cfg.block_rows).sum()
            a1 = devtrace.OPS_PER_CELL["stats"]
            self._add("A1", span.sum() * 2 * B * a1,
                      2 * span.sum() + (2 * B + 12) * pieces)
            return fn(reads, panel, winners, cfg, *a, **k)

        def scan(fn, dd, k, w):
            self._add("D1", max(0, dd.n_codes - k + 1)
                      * devtrace.SCAN_OPS_WINDOW_PER_POSITION,
                      dd.n_codes * 9 / 8 + 4 * dd.offsets32.numel())
            return fn(dd, k, w)

        plain = lambda fn, *a, **k: fn(*a, **k)  # noqa: E731
        targets = [(ap, name, plain) for name in self.SPANS] + [
            (ap, "candidate_layout", layout), (ap, "dispatch_rev", rev),
            (ap, "compute_winner_stats", stats), (dev, "upload", plain),
            (dev_scan, "dispatch_scan", scan)]
        for module, name, body in targets:
            orig = getattr(module, name, None)
            if orig is None:
                # A step the program no longer has: its span and its work
                # go unseen, and the metrics that read them are left out.
                print(f"probe target {module.__name__}.{name} is gone",
                      file=sys.stderr)
                continue

            def wrapper(*a, _orig=orig, _body=body, _name=name, **k):
                with record_function(_name):
                    return _body(_orig, *a, **k)

            self._saved.append((module, name, orig))
            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()
        return False


def timed_stream(path):
    """A ``ReadStream`` of the program whose ``chunks()`` times each pull
    (``pull_s``) under a host span ``stream.next``."""
    from torch.profiler import record_function

    from svjedi_tpu_torch.io.fastq import ReadStream

    class TimedStream(ReadStream):
        pull_s = 0.0
        pulls = 0

        def chunks(self, chunk_reads, first=None):
            it = super().chunks(chunk_reads, first=first)
            while True:
                t0 = time.perf_counter()
                with record_function("stream.next"):
                    chunk = next(it, None)
                self.pull_s += time.perf_counter() - t0
                self.pulls += 1
                if chunk is None:
                    return
                yield chunk

    return TimedStream(str(path))


class Setup:
    """The cell's inputs and the catalogue built through the port."""

    def __init__(self, cell, seed: int, device, workdir: Path):
        from svjedi_tpu_torch.align.decoy import build_decoy
        from svjedi_tpu_torch.align.index import build_panel_index
        from svjedi_tpu_torch.config import AlignConfig, GenotypeConfig
        from svjedi_tpu_torch.graph.build import build_graph
        from svjedi_tpu_torch.graph.cluster import build_panel
        from svjedi_tpu_torch.graph.svparse import parse_vcf_svs

        g = cell.config["guarantees"]
        self.cell, self.device, self.workdir = cell, device, workdir
        t0 = time.monotonic()
        self.align_cfg = AlignConfig()
        self.geno_cfg = GenotypeConfig(min_support=g["min_support"],
                                       err=g["err"], d_over=g["d_over"])
        self.cat = cell.gen.make_catalogue(cell.config, seed)
        self.vcf_path = workdir / "catalogue.vcf"
        self.cat.write_vcf(self.vcf_path)
        self.fastq = workdir / "sample.fastq"
        self.sample = cell.gen.make_sample(self.cat, cell.mix, seed,
                                           self.fastq)
        t1 = time.monotonic()
        chroms = self.cat.fasta_dict()
        parsed = parse_vcf_svs(self.vcf_path,
                               {c: len(s) for c, s in chroms.items()})
        cfg = self.align_cfg
        self.panel = build_panel(
            build_graph(chroms, parsed), flank=cfg.flank,
            cluster_gap=cfg.cluster_gap,
            max_paths_per_cluster=cfg.max_paths_per_cluster,
            max_hops_per_path=cfg.max_hops_per_path)
        self.index = build_panel_index(
            self.panel, k=cfg.kmer, w=cfg.window,
            max_hits_per_minimizer=cfg.max_hits_per_minimizer)
        self.decoy = (build_decoy(
            self.panel, k=cfg.kmer, w=cfg.window,
            max_hits_per_minimizer=cfg.max_hits_per_minimizer)
            if cfg.decoy else None)
        #: Set-up's parts on the host clock: the inputs, the catalogue.
        self.inputs_s, self.catalogue_s = t1 - t0, time.monotonic() - t1

    def job(self, i: int) -> Job:
        """One whole job; a job that raises or writes no VCF is not ok."""
        from torch.profiler import record_function

        from svjedi_tpu_torch.align.pipeline import align_and_count
        from svjedi_tpu_torch.genotype.vcf_writer import write_genotyped_vcf

        c0 = time.process_time()
        t0 = time.perf_counter()
        timings: dict = {}
        stream = timed_stream(self.fastq)
        out = self.workdir / f"job{i % 2}.vcf"
        try:
            with record_function("align_and_count"):
                counts, audit, winners = align_and_count(
                    stream, self.panel, self.index, self.align_cfg,
                    self.geno_cfg, device=self.device, collect_audit=True,
                    timings=timings, decoy=self.decoy)
            del audit, winners
            t1 = time.perf_counter()
            with record_function("write_genotyped_vcf"):
                write_genotyped_vcf(self.vcf_path, out, counts,
                                    min_support=self.geno_cfg.min_support,
                                    err=self.geno_cfg.err)
            t2 = time.perf_counter()
            text = out.read_text()
            ok = bool(text) and stream.total_bases == self.sample.n_bases
        except Exception:  # a failed job is counted, and judged below
            traceback.print_exc()
            return Job(seconds=time.perf_counter() - t0, ok=False,
                       cpu_s=time.process_time() - c0)
        return Job(seconds=t2 - t0, ok=ok, timings=timings,
                   stream_s=stream.pull_s if stream.pulls else None,
                   genotype_s=t2 - t1, vcf=text, counts=counts,
                   cpu_s=time.process_time() - c0)


def window(job, seconds: float):
    """Whole jobs back to back until ``seconds`` have passed, the last one
    finished: (jobs, start, end) on the host clock. A job ends with its VCF
    written, so nothing of it is left on the card."""
    jobs = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() < t0 + seconds:
        jobs.append(job(len(jobs)))
    return jobs, t0, time.perf_counter()


def mbases_per_s(jobs, n_bases: int, t0: float, t1: float) -> float:
    """Read bases of the completed jobs over the window's wall time."""
    return sum(j.ok for j in jobs) * n_bases / (t1 - t0) / 1e6


def judge(setup: Setup, jobs, limits: dict) -> dict:
    """Every job's numbers against the reference; the worst over jobs."""
    g = setup.cell.config["guarantees"]
    ref = setup.cell.reference
    catalogue = setup.vcf_path.read_text()
    truth = ref.truth_counts(setup.cat, setup.sample, g["d_over"])
    ref_cols = ref.expected_columns(
        catalogue, ref.reference_counts(catalogue, truth),
        g["min_support"], g["err"])
    worst = {"ad_gap": 0.0, "model_mismatch": 0}
    for job in jobs:
        if not job.ok:
            continue
        got = ref.compare(catalogue, job.vcf, job.counts, ref_cols,
                          g["min_support"], g["err"])
        for k in worst:
            worst[k] = max(worst[k], got[k])
    failed = sum(not j.ok for j in jobs)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    checks["failed_jobs"] = {"value": failed, "limit": 0}
    return checks


class Card:
    """The device-only steps of a run, on card 0: the port's libraries,
    the profiler's CUDA activity, peak memory, the trace and the card's
    description. The harness's CPU tests hand ``run_cell`` a stand-in."""

    platform = "gpu"

    def __init__(self, chips: int):
        import torch

        self.torch, self.chips = torch, chips
        self.device = torch.device("cuda:0")

    def build(self) -> None:
        from svjedi_tpu_torch.kernels import build

        build.build_native()
        build.load_library()

    def activities(self) -> list:
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def reset_peak(self) -> None:
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def int32_peak(self) -> float:
        return devtrace.int32_peak()

    def read_trace(self, prof, path: Path) -> dict:
        prof.export_chrome_trace(str(path))
        try:
            return devtrace.device_busy(path)
        finally:
            path.unlink()

    def describe(self) -> dict:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return {"platform": self.platform,
                "kind": self.torch.cuda.get_device_name(0),
                "count": self.chips,
                "visible": self.torch.cuda.device_count(),
                "power_limit": out.stdout.strip()}


def run_cell(cell, seed: int, seconds: float, trace: bool, card,
             out=None) -> int:
    """Set-up, window, judgement and the result line (to ``out``, default
    standard output); returns the exit code. ``card`` is a :class:`Card`."""
    out = out or sys.stdout

    t_build = time.monotonic()
    card.build()
    build_s = time.monotonic() - t_build
    with tempfile.TemporaryDirectory(prefix="svjt-bench-") as tmp:
        setup = Setup(cell, seed, card.device, Path(tmp))
        t_warm = time.monotonic()
        warm = setup.job(-1)
        if not warm.ok:
            print("the warm job failed", file=sys.stderr)
        peak_ops = card.int32_peak() if trace else None
        card.reset_peak()
        setup_s = time.monotonic() - T_START
        parts = {"build_s": build_s, "inputs_s": setup.inputs_s,
                 "catalogue_s": setup.catalogue_s,
                 "warm_job_s": time.monotonic() - t_warm}

        probes = prof = None
        c0 = time.process_time()
        with contextlib.ExitStack() as traced:
            if trace:
                from torch.profiler import profile

                probes = traced.enter_context(Probes(setup.align_cfg))
                prof = traced.enter_context(
                    profile(activities=card.activities()))
            jobs, t0, t1 = window(setup.job, seconds)
        host = {"cpus": os.cpu_count(),
                "cpu_per_wall": (time.process_time() - c0) / (t1 - t0)}
        device_peak = card.peak_bytes()
        host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

        done = [j for j in jobs if j.ok]
        metrics, breakdown, dev_extra = {}, None, {}
        if not trace:
            values = {"genotype_mbases_per_s": mbases_per_s(
                jobs, setup.sample.n_bases, t0, t1), "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        else:
            tr = card.read_trace(prof, Path(tmp) / "trace.json")
            if tr is not None:
                dev_extra = {"busy_s": tr["busy_us"] / 1e6,
                             "window_s": tr["window_us"] / 1e6}
                breakdown = {
                    "device_ops": [
                        [n[:160], v[0] / 1e6] for n, v in sorted(
                            tr["kernels"].items(),
                            key=lambda kv: -kv[1][0])[:10]],
                    "idle_gaps": [
                        [n, s / 1e6] for n, s in devtrace.name_gaps(
                            tr["gaps"], tr["spans"])],
                }
            ctx = {"jobs": done, "trace": tr, "work": probes.work,
                   "peak_ops": peak_ops, "device_peak_bytes": device_peak,
                   "host_peak_bytes": host_peak}
            for m in cell.per_layer:
                value = cellmod.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del prof, probes
        checks = judge(setup, jobs, cell.limits)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = card.describe()
    device_info.update(memory_peak_bytes=device_peak, **dev_extra)
    host["cpu_s_per_job"] = (sum(j.cpu_s for j in done) / len(done)
                             if done else None)
    result = {"correct": correct, "attempted": len(jobs),
              "failed": len(jobs) - len(done), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = parts
    result["host"] = host
    result["checks"] = checks
    print("job seconds: " + " ".join(f"{j.seconds:.3f}" for j in jobs)
          + f" (window {t1 - t0:.3f} s)", file=sys.stderr)
    print("job cpu_s: " + " ".join(f"{j.cpu_s:.3f}" for j in jobs),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cellmod.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    Card(cell.chips))


if __name__ == "__main__":
    raise SystemExit(main())
