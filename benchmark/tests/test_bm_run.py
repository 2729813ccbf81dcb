"""The window, the rate over whole jobs, a run's last line, and the
configuration's generator and reference as the only ones a run and the
calibration call, on the CPU at a tiny size (the harness's look for a card
skipped)."""

import re
import time

import pytest

from conftest import run_tiny

from benchmark import run


def test_window_runs_whole_jobs_past_the_deadline():
    def job(i):
        time.sleep(0.05)
        return run.Job(seconds=0.05, ok=i != 2)

    jobs, t0, t1 = run.window(job, 0.2)
    assert len(jobs) >= 4
    assert t1 - t0 >= 0.2 and t1 - t0 < 0.2 + 0.05 + 0.04
    # The failed job's bases do not count; its time does.
    ok = sum(j.ok for j in jobs)
    assert run.mbases_per_s(jobs, 2_000_000, t0, t1) == pytest.approx(
        ok * 2.0 / (t1 - t0))


def test_last_line_keys_untraced_and_traced(tiny_cell):
    res = run_tiny(tiny_cell, 31)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "setup", "host", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"genotype_mbases_per_s", "setup_s"}
    assert res["metrics"]["setup_s"]["unit"] == "s"
    assert set(res["checks"]) == {"ad_gap", "model_mismatch", "failed_jobs"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    # A CPU run never names a device metric as the card's.
    assert res["device"]["platform"] == "cpu"
    assert set(res["setup"]) == {"build_s", "inputs_s", "catalogue_s",
                                 "warm_job_s"}
    assert res["host"]["cpu_s_per_job"] > 0 and res["host"]["cpus"] >= 1
    assert res["host"]["cpu_per_wall"] > 0

    res = run_tiny(tiny_cell, 32, trace=True)
    assert list(res)[-1] == "checks" and res["correct"] is True
    got = set(res["metrics"])
    assert {"stream_ms_per_job", "seed_cpu_ms_per_job",
            "audit_assembly_ms_per_job", "genotype_ms_per_job",
            "host_peak_gb"} <= got
    # Device metrics have no CPU reading: left out, never 0.
    assert not got & {"dp_roofline_pct", "audit_dp_roofline_pct",
                      "scan_roofline_pct", "device_idle_pct",
                      "device_peak_gb"}


def test_no_card_exits_without_a_result(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "sim10mb-catalog1k.clr20x", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(capsys):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rc = run.main(["--workload", "sim10mb-catalog1k.clr20x", "--seed", "7",
                   "--seconds", "2"])
    import json

    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"



GEN_CALLS = ("make_catalogue", "make_sample")
REFERENCE_CALLS = ("truth_counts", "reference_counts", "expected_columns",
                   "compare", "control_vcf", "vcf_records")


class Recorder:
    """A configuration's module as the harness sees it: the real module
    behind it, each call the harness makes through it recorded, and
    ``inside`` counting calls under way."""

    def __init__(self, real, inside):
        self.real, self.inside, self.calls = real, inside, []

    def __getattr__(self, name):
        attr = getattr(self.real, name)
        if not callable(attr):
            return attr

        def call(*a, **k):
            self.calls.append(name)
            self.inside[0] += 1
            try:
                return attr(*a, **k)
            finally:
                self.inside[0] -= 1

        return call


@pytest.fixture
def recorded(tiny_cell, monkeypatch):
    """``tiny_cell`` with recording stand-ins for its generator and
    reference, and the list of contract calls that reached the real modules
    without going through them."""
    from benchmark import gen, reference

    inside, bypassed = [0], []
    for module, names in ((gen, GEN_CALLS), (reference, REFERENCE_CALLS)):
        for name in names:
            def guard(*a, _orig=getattr(module, name), _name=name, **k):
                if not inside[0]:
                    bypassed.append(_name)
                return _orig(*a, **k)

            monkeypatch.setattr(module, name, guard)
    tiny_cell.gen = Recorder(gen, inside)
    tiny_cell.reference = Recorder(reference, inside)
    return tiny_cell, bypassed


def test_run_and_calibrate_call_the_cells_modules(recorded, monkeypatch,
                                                  capsys):
    """``run.py`` and ``calibrate.py`` reach the generator and the reference
    only through the cell, never through a module of their own."""
    import json

    from benchmark import calibrate, cells

    cell, bypassed = recorded
    assert not hasattr(run, "gen") and not hasattr(run, "reference")
    assert not hasattr(calibrate, "gen") and not hasattr(calibrate,
                                                         "reference")
    res = run_tiny(cell, 33)
    assert res["correct"] is True
    assert set(cell.gen.calls) == set(GEN_CALLS)
    assert {"truth_counts", "reference_counts", "expected_columns",
            "compare"} <= set(cell.reference.calls)

    monkeypatch.setattr(cells, "load_cell", lambda name: cell)
    cell.gen.calls.clear()
    cell.reference.calls.clear()
    assert calibrate.main(["--workload", cell.name, "--seeds", "34",
                           "--control-only"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["side"] == "control" and line["model_mismatch"] > 0
    assert cell.gen.calls == list(GEN_CALLS)
    assert "control_vcf" in cell.reference.calls
    assert bypassed == []


@pytest.mark.parametrize("key,stem", [("generator", "gen_nosuch"),
                                      ("reference", "reference_nosuch"),
                                      ("generator", "../gen")])
def test_unknown_module_is_refused_by_name(tmp_path, key, stem):
    """A configuration that names a module the checkout lacks fails in
    ``load_cell``, naming it, before any set-up."""
    import json
    import shutil

    from conftest import ROOT

    from benchmark import cells

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "benchmark/configs/sim10mb-catalog1k.json"
    cfg = json.loads(path.read_text())
    cfg[key] = stem
    path.write_text(json.dumps(cfg))
    with pytest.raises(ModuleNotFoundError, match=re.escape(repr(stem))):
        cells.load_cell("sim10mb-catalog1k.clr20x", root=tmp_path)
