"""The align stage's spans and work counters (``utils/spans.py`` and the keys
``align_and_count`` writes into ``timings``), and the benchmark's readers of
them.

One job runs on a simulated genome with the ``v3`` engine (its plain
version on the CPU) and the device scan (its plain version, chaining in the
port's native library), inside ``benchmark.run.Probes``: every key is
written, the nested spans fit in their parents, and the counters give the
probes' counted work exactly. The seeding's counters are held to what the
job's seeding and decoy calls were handed, and the density floor's to a
direct filter of synthetic rows around it.
"""

import contextlib
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells, devtrace
from benchmark.run import Probes
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.utils import native as tnative
from svjedi_tpu_torch.utils import spans
from test_torch_dev_scan import native_installed, port_native  # noqa: F401
from test_torch_elect import _case, _reads, _winners

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: Keys ``align_and_count`` wrote before the spans: the benchmark's metrics
#: and ``bench.py``'s log read them.
OLD_KEYS = ("seed_s", "seed_cpu_s", "dp_s", "fwd_exec_s", "rev_disp_s",
            "rev_exec_s", "count_s", "audit_assembly_s", "audit_dp_s",
            "n_candidates", "n_winners")
#: The counting step's work counters.
COUNT_COUNTERS = ("count_entries", "count_crossings", "audit_line_rows")
#: The counters of INV and BND work and of paths across chromosomes, none of
#: which this job's one-chromosome DEL/INS catalogue has; and the decoy's
#: and the density floor's removals, which it may lack.
ALLTYPES_COUNTERS = ("count_crossings_inv", "count_crossings_bnd",
                     "dp_rows_inv_bnd", "rev_rows_inv_bnd",
                     "winners_cross_chrom")
#: The metrics this change adds, each with the key it reads.
NEW_METRICS = {
    "merge_index_ms_per_job": "merge_index_s",
    "pull_ms_per_job": "pull_s",
    "upload_ms_per_job": "upload_s",
    "scan_wait_ms_per_job": "scan_wait_s",
    "finalize_ms_per_job": "finalize_s",
    "prune_ms_per_job": "prune_s",
    "count_support_ms_per_job": "count_support_s",
    "audit_table_ms_per_job": "audit_table_s",
    "chain_ms_per_job": "chain_s",
}
#: Counters that may read 0 on a random-sequence job.
MAYBE_ZERO = ("decoy_suppressed", "density_dropped")


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_span_adds_seconds_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timings = {}
    for _ in range(2):
        with spans.span(timings, "a_s", "align.a"):
            time.sleep(0.002)
    assert 0.004 <= timings["a_s"] < 1.0
    with spans.span(timings, None, "align.b"):
        pass
    assert list(timings) == ["a_s"]
    assert spans.span(None, "a_s", "align.a") is spans._NOTHING
    spans.add(timings, "n", 3)
    spans.add(timings, "n", np.int64(4))
    spans.add(None, "n", 5)
    assert timings["n"] == 7 and type(timings["n"]) is int


def test_span_is_a_user_annotation_under_the_profiler(tmp_path):
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span(timings, "outer_s", "align.outer"):
            with spans.span(None, None, "align.inner"):
                torch.ones(8).sum()
    assert timings["outer_s"] > 0
    marks = {e["name"]: e for e in _events(prof, tmp_path)
             if e.get("cat") == "user_annotation"}
    assert {"align.outer", "align.inner"} <= set(marks)
    outer, inner = marks["align.outer"], marks["align.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_span_on_a_thread_the_profiler_was_not_started_on(tmp_path):
    """The profiler records per thread: such a span counts its seconds but
    leaves no range in the trace (the seeder thread's ``align.seed``)."""
    timings = {}

    def work():
        with spans.span(timings, "t_s", "align.elsewhere"):
            time.sleep(0.001)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert timings["t_s"] > 0
    assert not any(e.get("name") == "align.elsewhere"
                   for e in _events(prof, tmp_path))


@pytest.fixture(scope="module")
def job(tmp_path_factory, port_native):  # noqa: F811
    """One streamed ``align_and_count`` job (v3, decoy, audit, the device
    scan; three chunks, two flushes) inside the benchmark's probes: its
    timings, the probes' work, its wall seconds and its config."""
    from svjedi_tpu_torch.align.decoy import build_decoy
    from svjedi_tpu_torch.align.index import build_panel_index
    from svjedi_tpu_torch.config import AlignConfig, GenotypeConfig
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.cluster import build_panel
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
    from svjedi_tpu_torch.io import sim
    from svjedi_tpu_torch.io.fastq import ReadStream

    tmp = tmp_path_factory.mktemp("torch_spans")
    s = sim.simulate(seed=5, chrom_lengths={"chrA": 60000}, n_svs=8,
                     sv_types=("DEL", "INS"))
    names, seqs = sim.simulate_reads(np.random.default_rng(5), s.haplotypes,
                                     coverage=10.0, mean_len=2000,
                                     sd_len=500)
    sim.write_truth_vcf(s, tmp / "truth.vcf")
    sim.write_fastq(tmp / "reads.fastq", names, seqs)
    cfg = AlignConfig()
    parsed = parse_vcf_svs(tmp / "truth.vcf",
                           {c: len(x) for c, x in s.chroms.items()})
    panel = build_panel(
        build_graph(s.chroms, parsed), flank=cfg.flank,
        cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
        max_hops_per_path=cfg.max_hops_per_path)
    hits = cfg.max_hits_per_minimizer
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window,
                              max_hits_per_minimizer=hits)
    decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                        max_hits_per_minimizer=hits)
    timings = {}
    # Each election's rows and rounds, each prune's input rows and each
    # finalize_chunk's winners, seen from outside the functions; and the
    # seeding's view: the chains seeded, each decoy competition's arguments
    # and result, the rows below the density floor of each
    # prune_secondaries, and the seeder's (chain_s, seed_cpu_s) per chunk.
    seen = {"elect": [], "prune": [], "finalize": [], "seeded": [],
            "competed": [], "below_floor": [], "chunk_spans": []}
    floor = cfg.min_density_millis

    def pruned(winners):
        span = np.maximum(winners.qe - winners.qs + 1,
                          winners.te - winners.ts + 1)
        seen["below_floor"].append(
            int((winners.score * 1000 < floor * span).sum()))
        return len(winners.read)

    def spy(name, record):
        fn = getattr(tpipe, name)

        def wrapper(*a, **k):
            out = fn(*a, **k)
            seen[record[0]].append(record[1](a, out))
            return out

        return name, fn, wrapper

    spies = [
        spy("elect", ("elect", lambda a, out: (len(a[0]), out[2]))),
        spy("prune_secondaries", ("prune", lambda a, out: pruned(a[0]))),
        spy("cross_cluster_prune", ("prune", lambda a, out: len(a[0].read))),
        spy("finalize_chunk", ("finalize", lambda a, out: len(out[0].read))),
        spy("seed_candidates", ("seeded", lambda a, out: out)),
        spy("suppress_merged", ("competed", lambda a, out: (a, out))),
    ]
    span = tpipe.span
    chunk = {}

    @contextlib.contextmanager
    def span_spy(spent, key, name):
        with span(spent, key, name):
            yield
        # The seeder's spans close chain_s, then seed_cpu_s, per chunk.
        if key == "chain_s":
            chunk["chain_s"] = spent[key]
        elif key == "seed_cpu_s":
            seen["chunk_spans"].append((chunk.pop("chain_s"), spent[key]))

    with native_installed(port_native, tnative), Probes(cfg) as probes:
        assert tpipe.use_device_scan(cfg)
        for name, _, wrapper in spies:
            setattr(tpipe, name, wrapper)
        tpipe.span = span_spy
        try:
            t0 = time.perf_counter()
            counts, _, winners = tpipe.align_and_count(
                ReadStream(str(tmp / "reads.fastq")), panel, index, cfg,
                GenotypeConfig(), device=CPU, timings=timings, decoy=decoy,
                chunk_reads=30, flush_every=2, engine="v3")
            wall = time.perf_counter() - t0
        finally:
            tpipe.span = span
            for name, fn, _ in reversed(spies):
                setattr(tpipe, name, fn)
    assert counts and len(winners.read) > 0
    return SimpleNamespace(timings=timings, work=probes.work, wall=wall,
                           cfg=cfg, n_reads=len(names), counts=counts,
                           seen=seen)


def test_job_writes_every_key(job):
    t = job.timings
    for key in (tpipe.LOOP_SPANS + tpipe.NESTED_SPANS + tpipe.WORK_COUNTERS
                + OLD_KEYS):
        assert key in t, key
    assert t["n_chunks"] == 3
    for key in tpipe.LOOP_SPANS + tpipe.NESTED_SPANS:
        assert t[key] > 0, key
    for key in tpipe.WORK_COUNTERS:
        assert type(t[key]) is int, key
        if key in ALLTYPES_COUNTERS:
            assert t[key] == 0, key
        elif key not in MAYBE_ZERO:
            assert t[key] > 0, key
    for key in MAYBE_ZERO:
        assert t[key] >= 0, key


def test_nested_spans_fit_in_their_parents(job):
    t = job.timings
    assert t["finalize_s"] <= t["rev_disp_s"]
    assert (t["prune_s"] + t["count_support_s"] + t["audit_table_s"]
            + t["audit_assembly_s"] + t["audit_dp_s"]) <= t["count_s"]
    assert t["scan_wait_s"] + t["decoy_s"] + t["chain_s"] <= t["seed_cpu_s"]
    assert sum(t[k] for k in tpipe.LOOP_SPANS) <= job.wall


def test_counters_give_the_probes_work_exactly(job):
    """The roofline metrics' work, computed from the program's counters with
    the frozen arithmetic of ``devtrace.py``, equals what the probes count
    by wrapping the program's functions."""
    t, band = job.timings, job.cfg.band
    k1 = devtrace.OPS_PER_CELL["k1"]
    a1 = devtrace.OPS_PER_CELL["stats"]
    expected = {
        "K1": [t["dp_rows"] * band * k1,
               2 * t["dp_rows"] + (band + 12) * t["dp_problems"]],
        "K1'": [t["rev_rows"] * band * k1,
                2 * t["rev_rows"] + (band + 16) * t["rev_problems"]],
        "A1": [t["audit_rows"] * 2 * band * a1,
               2 * t["audit_rows"] + (2 * band + 12) * t["audit_pieces"]],
        "D1": [t["scan_positions"] * devtrace.SCAN_OPS_WINDOW_PER_POSITION,
               t["scan_codes"] * 9 / 8 + 4 * t["scan_offsets"]],
    }
    for kernel, (ops, n_bytes) in expected.items():
        assert ops > 0 and n_bytes > 0, kernel
        assert job.work[kernel] == [float(ops), float(n_bytes)], kernel
    assert t["scan_offsets"] == job.n_reads + t["n_chunks"]


def test_count_counters_add_up(job):
    """The counting step's counters: every crossing counted is an entry
    tested, and each audit line formatted serves one or more crossings."""
    t = job.timings
    for key in COUNT_COUNTERS:
        assert key in tpipe.WORK_COUNTERS, key
    assert t["count_crossings"] == sum(a + b for a, b in job.counts.values())
    assert t["count_entries"] >= t["count_crossings"] >= t["audit_line_rows"]
    assert t["audit_line_rows"] > 0


def test_election_counters_count_the_elections(job):
    """``elect_rows`` is the rows handed to the three elections of each
    chunk (``finalize_chunk``'s alive chains, each prune's input winners),
    and ``elect_rounds`` the rounds they took."""
    t, seen = job.timings, job.seen
    assert len(seen["finalize"]) == t["n_chunks"] == 3
    assert len(seen["prune"]) == 2 * t["n_chunks"]
    assert len(seen["elect"]) == 3 * t["n_chunks"]
    assert t["elect_rows"] == sum(rows for rows, _ in seen["elect"])
    assert t["elect_rounds"] == sum(rounds for _, rounds in seen["elect"])
    # The prunes elect over their whole input; finalize_chunk over its
    # alive chains, at least one a winner, at most one a candidate.
    finalized = t["elect_rows"] - sum(seen["prune"])
    assert sum(seen["finalize"]) <= finalized <= t["n_candidates"]
    assert seen["prune"][0] == seen["finalize"][0]
    assert 1 <= t["elect_rounds"] <= t["elect_rows"]


def test_chain_span_nests_in_each_chunks_seeding(job):
    """``chain_s`` closes inside ``seed_cpu_s`` in every chunk, and the
    chunks' sum is the job's."""
    chunks = job.seen["chunk_spans"]
    assert len(chunks) == job.timings["n_chunks"] == 3
    for chain_s, seed_cpu_s in chunks:
        assert 0 < chain_s <= seed_cpu_s
    assert job.timings["chain_s"] == pytest.approx(sum(c for c, _ in chunks))


def test_decoy_chains_are_the_rows_the_suppression_receives(job):
    """The decoy rows among the merged rows each competition received
    (paths from ``n_panel_paths`` on)."""
    calls = job.seen["competed"]
    assert len(calls) == job.timings["n_chunks"]
    rows = [int((a[1].path >= a[2]).sum()) for a, _ in calls]
    assert job.timings["decoy_chains"] == sum(rows) > 0


def test_decoy_panel_chains_counts_the_boundary_path(job):
    """With the library built, each competition judged every panel chain of
    its rows from chain boundaries; without it the same rows take the
    row-copying sequence, which counts 0 and keeps the same rows."""
    judged = 0
    for (chunk, cands, n_panel, index, decoy), (kept, counts) in (
            job.seen["competed"]):
        head = np.ones(len(cands), dtype=bool)
        head[1:] = cands.chain[1:] != cands.chain[:-1]
        judged += int((cands.path[head] < n_panel).sum())
        assert counts["decoy_panel_chains"] > 0
        with native_installed(None, tnative):
            plain, plain_counts = tpipe.suppress_merged(
                chunk, cands, n_panel, index, decoy)
        assert plain_counts == dict(counts, decoy_panel_chains=0)
        for name in ("read", "chain", "d0", "dec_other", "dec_same"):
            assert np.array_equal(getattr(plain, name), getattr(kept, name))
    assert job.timings["decoy_panel_chains"] == judged > 0


def test_chain_anchors_sum_each_chain_once(job):
    """A plain per-chain sum over every chunk's seeded rows: each chain's
    anchors (the same on all its block rows) counted once."""
    total = 0
    for cands in job.seen["seeded"]:
        chains = {}
        for c, a in zip(cands.chain.tolist(), cands.n_anchors.tolist()):
            assert chains.setdefault(c, a) == a
        total += sum(chains.values())
    assert len(job.seen["seeded"]) == job.timings["n_chunks"]
    assert job.timings["chain_anchors"] == total > 0


def test_density_dropped_counts_the_jobs_floor(job):
    assert job.timings["density_dropped"] == sum(job.seen["below_floor"])


@pytest.mark.parametrize("name", ["density", "ties", "empty"])
def test_density_dropped_counts_the_floor(name):
    """On rows around the floor (500 per 1,000 bases), ``density_dropped``
    is the rows a direct filter puts below it."""
    c = _case(name, 29)
    cfg = SimpleNamespace(min_density_millis=500)
    w = _winners(tpipe, c)
    below = int((w.score * 1000 < 500 * np.maximum(
        w.qe - w.qs + 1, w.te - w.ts + 1)).sum())
    timings = {}
    tpipe.prune_secondaries(w, _reads(c), cfg, timings=timings)
    assert timings.get("density_dropped", 0) == below
    assert (below > 0) == (name == "density")
    timings = {}
    tpipe.prune_secondaries(_winners(tpipe, c), _reads(c), timings=timings)
    assert timings.get("density_dropped", 0) == 0


def test_decoy_chains_reader():
    read = cells.metric_reader("decoy_chains_k_per_job")
    ctx = _ctx({"timings": {"decoy_chains": 3000}},
               {"timings": {"decoy_chains": 5000}})
    assert read(ctx) == pytest.approx(4.0)
    assert read(_ctx({"timings": {"decoy_chains": 1}},
                     {"timings": {}})) is None
    assert read(_ctx()) is None


def _ctx(*jobs):
    return {"jobs": [SimpleNamespace(**j) for j in jobs]}


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_new_metric_reads_its_key(metric):
    read = cells.metric_reader(metric)
    key = NEW_METRICS[metric]
    ctx = _ctx({"timings": {key: 0.25}}, {"timings": {key: 0.5}})
    assert read(ctx) == pytest.approx(375.0)
    assert read(_ctx({"timings": {key: 0.25}}, {"timings": {}})) is None
    assert read(_ctx()) is None


def test_unspanned_is_the_job_less_its_spans_and_genotyping():
    read = cells.metric_reader("unspanned_ms_per_job")
    loop = dict.fromkeys(tpipe.LOOP_SPANS, 0.1)  # 1.2 s in all
    jobs = [{"seconds": 2.0, "genotype_s": 0.3, "timings": loop},
            {"seconds": 1.6, "genotype_s": 0.2,
             "timings": {**loop, "finalize_s": 9.0}}]
    assert read(_ctx(*jobs)) == pytest.approx(1e3 * (0.5 + 0.2) / 2)
    short = {k: v for k, v in loop.items() if k != "trim_s"}
    assert read(_ctx(jobs[0], {**jobs[1], "timings": short})) is None
