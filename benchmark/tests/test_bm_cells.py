"""BENCHMARK.json against the contract's shape, and cells, mixes, limits,
metric readers and configurations' generators and references found by name,
also ones added as new files."""

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in b["end_to_end"]} == {
        "genotype_mbases_per_s", "setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] == "genotype_mbases_per_s"
        # Every per-layer entry has its reader, however many there are.
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_every_configuration_names_module_files():
    """Each configuration's generator and reference, given or defaulted,
    is a module file under benchmark/."""
    from benchmark import cells

    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key, default in cells.DEFAULT_MODULES.items():
            stem = cfg.get(key, default)
            assert cells.STEM.fullmatch(stem), (c["name"], key, stem)
            assert (ROOT / "benchmark" / f"{stem}.py").is_file(), stem


def test_every_cell_loads_with_its_files():
    from benchmark import cells

    configs = {c["name"]: c["file"] for c in bench()["configs"]}
    for w in bench()["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert set(cell.limits) == {"ad_gap", "model_mismatch"}
        assert cell.limits["model_mismatch"] == 0
        cfg = json.loads((ROOT / configs[w["config"]]).read_text())
        assert cell.gen.__name__ == "benchmark." + cfg.get("generator", "gen")
        assert cell.reference.__name__ == "benchmark." + cfg.get(
            "reference", "reference")
        for fn in ("make_catalogue", "make_sample"):
            assert callable(getattr(cell.gen, fn))
        for fn in ("truth_counts", "reference_counts", "expected_columns",
                   "compare", "control_vcf", "vcf_records"):
            assert callable(getattr(cell.reference, fn))
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


def test_added_mix_cell_and_metric_need_no_edit(tmp_path):
    """A later change adds a mix, a cell, its limits and a metric as new files
    and entries; the harness finds them without a change to its code."""
    from benchmark import cells

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    b["workloads"].append({"name": "sim10mb-catalog1k.dummy",
                           "config": "sim10mb-catalog1k", "traffic": "dummy",
                           "chips": 1, "why": "a cell added by a test"})
    b["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "genotype",
                           "moves": "genotype_mbases_per_s",
                           "workloads": ["sim10mb-catalog1k.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    mix = json.loads((ROOT / "benchmark/mixes/clr20x.json").read_text())
    mix["coverage"] = 8
    (tmp_path / "benchmark/mixes/dummy.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/limits/sim10mb-catalog1k.dummy.json").write_text(
        json.dumps({"ad_gap": 0.1, "model_mismatch": 0}))
    (tmp_path / "benchmark/metrics/dummy_ms.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    cell = cells.load_cell("sim10mb-catalog1k.dummy", root=tmp_path)
    assert cell.mix["coverage"] == 8 and cell.mix["name"] == "dummy"
    assert [m["name"] for m in cell.per_layer][-1] == "dummy_ms"
    assert cells.metric_reader("dummy_ms", root=tmp_path)({}) == 7.0
    # The new metric belongs to the new cell only.
    old = cells.load_cell("sim10mb-catalog1k.clr20x", root=tmp_path)
    assert "dummy_ms" not in [m["name"] for m in old.per_layer]


def test_unknown_cell_is_refused():
    from benchmark import cells

    with pytest.raises(KeyError):
        cells.load_cell("no-such.cell")


def test_added_configuration_brings_its_own_modules(tmp_path):
    """A later change adds a configuration whose file names its own
    generator and reference, as new files; ``load_cell`` puts those modules
    on the cell, from that checkout, without a change to the harness."""
    from benchmark import cells, gen, reference

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    b["configs"].append({"name": "other", "source": "a test",
                         "file": "benchmark/configs/other.json",
                         "reduced": [], "why": "a configuration added"})
    b["workloads"].append({"name": "other.clr20x", "config": "other",
                           "traffic": "clr20x", "chips": 1,
                           "why": "a cell added by a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = json.loads(
        (ROOT / "benchmark/configs/sim10mb-catalog1k.json").read_text())
    cfg.update(generator="gen_other", reference="reference_other")
    (tmp_path / "benchmark/configs/other.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/limits/other.clr20x.json").write_text(
        json.dumps({"ad_gap": 0.02, "model_mismatch": 0}))
    (tmp_path / "benchmark/gen_other.py").write_text(
        "from .gen import *  # noqa: F401,F403\nWHO = 'gen_other'\n")
    (tmp_path / "benchmark/reference_other.py").write_text(
        "from .reference import *  # noqa: F401,F403\n"
        "WHO = 'reference_other'\n")
    cell = cells.load_cell("other.clr20x", root=tmp_path)
    assert cell.gen.WHO == "gen_other"
    assert cell.reference.WHO == "reference_other"
    assert cell.gen.__file__ == str(tmp_path / "benchmark/gen_other.py")
    # The configuration that names none keeps the defaults.
    old = cells.load_cell("sim10mb-catalog1k.clr20x")
    assert old.gen is gen and old.reference is reference
