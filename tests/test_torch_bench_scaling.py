"""``python -m svjedi_tpu_torch.bench_scaling`` vs ``tools/bench_scaling.py`` (CPU).

On a simulated bundle with the three file names the tools read, both run
the ``xla`` count step (``band_dp_batch``: the port's plain version, JAX's
``lax.scan``) on the same candidates, so the problem count, the load
balance and the counts of the one-device and the 1 x 1 sharded step must
agree exactly across the packages. The JAX tool is loaded from its file
with its ``TEST_DIR`` pointed at the bundle; its two step functions are
wrapped so that each runs once and its timing loop replays the result (the
sharded step's own, traced call of the one-device step goes through). The
port's tool runs with one timed call per step, its DP memoised on its exact
inputs: the plain DP at bucket 2,048 takes tens of seconds on one thread,
and both steps give it the same windows.
Without a card and without ``--cpu`` the port's tool refuses; without the
bundle both raise, naming the missing file.
"""

import contextlib
import gzip
import importlib.util
import io
import json
import shutil

import numpy as np
import pytest
import torch

from svjedi_tpu.io import sim
from svjedi_tpu.io.fasta import write_fasta
from svjedi_tpu_torch import bench_scaling

from tests.conftest import REPO_ROOT

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """612 reads of ~3 kb over 150 kb with 50 SVs: 1,283 kept candidates
    with a window of at most 2,048 rows, so 1,024 problems."""
    tmp = tmp_path_factory.mktemp("scaling_bundle")
    s = sim.simulate(seed=7, chrom_lengths={"chr1": 150_000}, n_svs=50,
                     sv_types=("DEL", "INS", "INV"))
    names, seqs = sim.simulate_reads(np.random.default_rng(7), s.haplotypes,
                                     coverage=12.0, mean_len=3000,
                                     sd_len=1000)
    sim.write_truth_vcf(s, tmp / "test.vcf")
    write_fasta(tmp / "reference_genome.fasta", s.chroms)
    sim.write_fastq(tmp / "reads.fastq", names, seqs)
    with open(tmp / "reads.fastq", "rb") as src, \
            gzip.open(tmp / "simulated_reads.fastq.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return tmp


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_scaling", REPO_ROOT / "tools" / "bench_scaling.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _once(fn, results, key):
    """``fn`` run for its first concrete call only; later concrete calls
    return its result, traced calls run ``fn``."""
    import jax

    def wrapped(*args, **kwargs):
        if any(isinstance(a, jax.core.Tracer) for a in args):
            return fn(*args, **kwargs)
        if key not in results:
            results[key] = fn(*args, **kwargs)
        return results[key]
    return wrapped


def _memo_dp(fn):
    """The DP ``fn`` memoised on its exact inputs: a call on windows equal
    to the previous call's returns that call's result."""
    last = {}

    def wrapped(q, t, band, params):
        if not (last and last["key"] == (band, params)
                and torch.equal(last["q"], q) and torch.equal(last["t"], t)):
            last.update(key=(band, params), q=q, t=t,
                        out=fn(q, t, band, params))
        return last["out"]
    return wrapped


@pytest.fixture(scope="module")
def jax_run(bundle):
    """The JAX tool's JSON line and its two steps' counts."""
    from svjedi_tpu.dist import engine as jeng

    results = {}
    make_step = jeng.make_sharded_count_step_v3

    def sharded_factory(*args, **kwargs):
        return _once(make_step(*args, **kwargs), results, "sharded")

    tool = _jax_tool()
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "TEST_DIR", bundle)
        mp.setattr(jeng, "dp_filter_count_v3",
                   _once(jeng.dp_filter_count_v3, results, "single"))
        mp.setattr(jeng, "make_sharded_count_step_v3", sharded_factory)
        with contextlib.redirect_stdout(out):
            tool.main()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return (line, np.asarray(results["single"]["counts"]),
            np.asarray(results["sharded"]))


@pytest.fixture(scope="module")
def port_run(bundle):
    from svjedi_tpu_torch.dist import engine as teng

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teng, "band_dp_batch", _memo_dp(teng.band_dp_batch))
        return bench_scaling.measure(
            bundle / "reference_genome.fasta", bundle / "test.vcf",
            bundle / "simulated_reads.fastq.gz", torch.device("cpu"),
            reps=1)


def test_port_line_matches_jax_tool(jax_run, port_run):
    theirs, ours = jax_run[0], port_run.line
    assert list(ours) == list(theirs) == list(bench_scaling.KEYS)
    assert ours["platform"] == theirs["platform"] == "cpu"
    for key in ("engine", "n_problems", "load_balance_8dev_chunks"):
        assert ours[key] == theirs[key], key
    assert ours["engine"] == "xla"
    assert ours["n_problems"] == 1024
    assert 0 < ours["load_balance_8dev_chunks"] <= 1
    assert ours["t_single_s"] > 0 and ours["t_sharded_1dev_s"] > 0
    assert np.isfinite(ours["sharding_overhead_x"])
    assert 0 < ours["projected_8chip_efficiency"] <= 1
    # No band_dp_v3 on the xla engine.
    assert port_run.k1_launches == port_run.k1_rev_launches == 0


def test_counts_match_across_steps_and_packages(jax_run, port_run):
    _, jax_single, jax_sharded = jax_run
    assert jax_single.sum() > 0
    np.testing.assert_array_equal(jax_sharded, jax_single)
    np.testing.assert_array_equal(port_run.single_counts, jax_single)
    np.testing.assert_array_equal(port_run.sharded_counts, jax_single)


def test_main_prints_the_line(bundle, port_run, monkeypatch, capsys):
    """``main(["--cpu"])`` prints the line ``measure`` gives as one JSON
    object on stdout."""
    monkeypatch.setattr(bench_scaling, "TEST_DIR", bundle)
    monkeypatch.setattr(bench_scaling, "measure", lambda *args: port_run)
    assert bench_scaling.main(["--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == port_run.line


def test_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_scaling.main([])
    assert exc.value.code != 0
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.parametrize("package", ["svjedi_tpu_torch", "svjedi_tpu"])
def test_missing_bundle_names_the_file(package, tmp_path, monkeypatch):
    tool = bench_scaling if package == "svjedi_tpu_torch" else _jax_tool()
    monkeypatch.setattr(tool, "TEST_DIR", tmp_path)
    with pytest.raises(FileNotFoundError, match="reference_genome.fasta"):
        if tool is bench_scaling:
            tool.main(["--cpu"])
        else:
            tool.main()  # the JAX tool reads its one flag from sys.argv
