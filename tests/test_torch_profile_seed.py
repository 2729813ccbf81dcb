"""The port's seed profilers vs ``tools/profile_seed5.py`` and ``tools/profile_seed.py`` (CPU).

On a simulated bundle with the three file names the tools read, each JAX
tool is loaded from its file (it runs at import) with ``SVJT_TESTDIR``
pointed at the bundle and ``SVJT_BENCH_REPS=1``, and its printed counts
are held against the port's ``measure`` on the CPU: every iteration's
candidate count and the host-scan path's (``profile_seed5``); the kept,
block and raw minimizer counts of every trial and the panel and decoy
candidate counts of every full trial (``profile_seed``). Both packages run
on the port's native library, built here into a temporary directory (the
JAX package's loader is pointed at it; nothing of either package changes).
The port's device-scan candidates (the scan's plain version on the CPU)
must equal its host-scan candidates array by array. Each tool's ``main``
refuses without a card unless given ``--cpu``, raises naming a missing
bundle file, and does nothing at import.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import svjedi_tpu.align.seed as jseed
import svjedi_tpu.utils.native as jnative
from svjedi_tpu.io import sim
from svjedi_tpu.io.fasta import write_fasta
from svjedi_tpu_torch import profile_seed, profile_seed5
from svjedi_tpu_torch.kernels import build
from svjedi_tpu_torch.utils import native as tnative

from tests.conftest import REPO_ROOT
from tests.test_torch_dev_scan import build_native_into, native_installed

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOOLS = {"profile_seed5": profile_seed5, "profile_seed": profile_seed}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """~190 reads of ~3 kb over 120 kb with 20 SVs."""
    import gzip
    import shutil

    tmp = tmp_path_factory.mktemp("seed_bundle")
    s = sim.simulate(seed=5, chrom_lengths={"chr1": 120_000}, n_svs=20,
                     sv_types=("DEL", "INS", "INV"))
    names, seqs = sim.simulate_reads(np.random.default_rng(5), s.haplotypes,
                                     coverage=5.0, mean_len=3000,
                                     sd_len=1000)
    sim.write_truth_vcf(s, tmp / "test.vcf")
    write_fasta(tmp / "reference_genome.fasta", s.chroms)
    sim.write_fastq(tmp / "reads.fastq", names, seqs)
    with open(tmp / "reads.fastq", "rb") as src, \
            gzip.open(tmp / "simulated_reads.fastq.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return tmp


@pytest.fixture(scope="module")
def native_so(tmp_path_factory):
    so = build_native_into(tmp_path_factory.mktemp("native"))
    if so is None:
        pytest.skip("the port's native library cannot be built here")
    return so


def _run_jax_tool(name, test_dir):
    """Execute ``tools/<name>.py`` (it runs at import) on ``test_dir``;
    returns its stdout."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO_ROOT / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVJT_TESTDIR", str(test_dir))
        mp.setenv("SVJT_BENCH_REPS", "1")
        with contextlib.redirect_stdout(out):
            spec.loader.exec_module(tool)
    return out.getvalue()


def _bundle_args(bundle):
    return (bundle / "reference_genome.fasta", bundle / "test.vcf",
            bundle / "simulated_reads.fastq.gz")


@pytest.fixture(scope="module")
def jax_seed5(bundle, native_so):
    """The JAX tool's output and the candidate counts of its host-scan
    calls (``seed_candidates`` without ``bits``)."""
    host_counts = []
    seed_candidates = jseed.seed_candidates

    def recording(*args, **kwargs):
        cands = seed_candidates(*args, **kwargs)
        if kwargs.get("bits") is None:
            host_counts.append(len(cands))
        return cands

    with pytest.MonkeyPatch.context() as mp, \
            native_installed(native_so, jnative):
        mp.setattr(jseed, "seed_candidates", recording)
        text = _run_jax_tool("profile_seed5", bundle)
    return text, host_counts


@pytest.fixture(scope="module")
def port_seed5(bundle, native_so):
    with native_installed(native_so, tnative):
        return profile_seed5.measure(*_bundle_args(bundle), CPU)


@pytest.fixture(scope="module")
def jax_seed(bundle, native_so):
    with native_installed(native_so, jnative):
        return _run_jax_tool("profile_seed", bundle)


@pytest.fixture(scope="module")
def port_seed(bundle, native_so):
    with native_installed(native_so, tnative):
        return profile_seed.measure(*_bundle_args(bundle), CPU, reps=1)


def _ints(pattern, text):
    return [tuple(int(g) for g in m) if isinstance(m, tuple) else int(m)
            for m in re.findall(pattern, text)]


def _times(line):
    """Every number of a line that is a time (keys other than counts)."""
    for key, val in line.items():
        if isinstance(val, dict):
            yield from _times(val)
        elif isinstance(val, list):
            for row in val:
                yield from _times(row)
        elif isinstance(val, float):
            yield key, val


def test_seed5_counts_match_jax_tool(jax_seed5, port_seed5):
    text, jax_host = jax_seed5
    jax_iters = _ints(r"iter\d+: .* n_cands=(\d+)", text)
    line = port_seed5.line
    assert len(jax_iters) == len(line["iters"]) == 4
    assert [r["n_cands"] for r in line["iters"]] == jax_iters
    assert jax_iters[0] > 0
    assert jax_host == [line["n_cands_host_scan"]]
    assert line["n_cands_host_scan"] == jax_iters[0]
    assert "host scan+chain (svt_chain3)" in text


def test_seed5_device_scan_candidates_equal_host_scan(port_seed5):
    assert len(port_seed5.host_cands) > 0
    assert profile_seed5.differing_fields(port_seed5.device_cands,
                                          port_seed5.host_cands) == []


def test_seed5_line(bundle, port_seed5):
    line = port_seed5.line
    n_reads = sum(1 for _ in open(bundle / "reads.fastq")) // 4
    assert line["device"] == "cpu" and line["n_reads"] == n_reads
    for key in ("merge_indexes_s", "lookup_prebuild_s", "bitmap_build_s",
                "packed_hits_build_s", "chain5_threads_1", "chain5_threads_2",
                "chain5_threads_4", "host_scan_chain",
                "stream_first_chunk_s"):
        assert key in line, key
    assert line["cold"] == line["iters"][0]
    for key in profile_seed5.ITER_KEYS:
        assert line["warm"][key] == min(r[key] for r in line["iters"][1:])
    for key, t in _times(line):
        assert math.isfinite(t) and t > 0, (key, t)
    # The plain scan runs on the CPU: no launch, no kernel time.
    assert line["d1_launches"] == port_seed5.d1_launches == 0
    assert line["warm"]["d1_ms"] is None
    assert all(r["d1_ms"] is None for r in line["iters"])
    json.dumps(line)


def test_seed5_takes_the_first_n_reads(bundle, native_so):
    with native_installed(native_so, tnative):
        res = profile_seed5.measure(*_bundle_args(bundle), CPU, n_reads=40,
                                    iters=2)
    assert res.line["n_reads"] == 40 and len(res.line["iters"]) == 2
    assert set(res.device_cands.read.tolist()) <= set(range(40))
    assert profile_seed5.differing_fields(res.device_cands,
                                          res.host_cands) == []


def test_seed_counts_match_jax_tool(jax_seed, port_seed):
    line = port_seed.line
    head = re.search(r"reads=(\d+) .* index_hits=(\d+) uniq=(\d+)", jax_seed)
    assert (line["reads"], line["index_hits"], line["uniq"]) == tuple(
        int(g) for g in head.groups())
    trials = _ints(r"\[\d\] scan\+bitmap=\S+ \((\d+) kept\) chain2=\S+ "
                   r"\((\d+) blocks\) scan_raw=\S+ \((\d+) minimizers\)",
                   jax_seed)
    assert len(trials) == 3
    assert [(t["kept"], t["blocks"], t["minimizers"])
            for t in line["trials"]] == trials
    full = _ints(r"\[full \d\] .* n_panel=(\d+) n_dec=(\d+)", jax_seed)
    assert len(full) == 2
    assert [(f["n_panel"], f["n_dec"]) for f in line["full"]] == full
    assert full[0][0] > 0 and trials[0][1] > 0
    for key, t in _times(line):
        assert math.isfinite(t) and t > 0, (key, t)
    assert len(port_seed.panel_cands) == full[-1][0]
    assert port_seed.keep.shape == (full[-1][0],)


@pytest.mark.parametrize("name", list(TOOLS))
def test_main_prints_the_line(name, bundle, monkeypatch, capsys):
    """``main(["--cpu"])`` builds the native library, then prints the line
    ``measure`` gives as one JSON object on stdout."""
    tool = TOOLS[name]
    built, given = [], []
    fake = types.SimpleNamespace(line={"device": "cpu", "tool": name})
    monkeypatch.setattr(build, "build_native", lambda: built.append(1))
    monkeypatch.setattr(tool, "TEST_DIR", bundle)
    monkeypatch.setattr(tool, "measure",
                        lambda *args, **kw: given.append(args) or fake)
    assert tool.main(["--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == fake.line
    assert built == [1]
    assert given == [(*_bundle_args(bundle), CPU)]


@pytest.mark.parametrize("name", list(TOOLS))
def test_refuses_without_a_card_unless_asked_for_the_cpu(name, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        TOOLS[name].main([])
    assert exc.value.code != 0
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.parametrize("package", ["svjedi_tpu_torch", "svjedi_tpu"])
@pytest.mark.parametrize("name", list(TOOLS))
def test_missing_bundle_names_the_file(name, package, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="reference_genome.fasta"):
        if package == "svjedi_tpu":
            _run_jax_tool(name, tmp_path)
        else:
            monkeypatch.setattr(build, "build_native", lambda: None)
            monkeypatch.setattr(TOOLS[name], "TEST_DIR", tmp_path)
            TOOLS[name].main(["--cpu"])


def test_nothing_runs_at_import(tmp_path):
    """Importing the tools reads no bundle and prints nothing: they import
    with their bundle directory absent."""
    code = ("import svjedi_tpu_torch.profile_seed5 as a, "
            "svjedi_tpu_torch.profile_seed as b\n"
            "print(a.TEST_DIR, b.TEST_DIR)\n")
    missing = tmp_path / "absent"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT),
                 SVJT_TESTDIR=str(missing)),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(missing)] * 2
    assert not missing.exists()
