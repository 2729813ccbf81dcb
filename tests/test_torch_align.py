"""The port's align stage (CPU, plain DP) vs the JAX package's, on a simulated genome.

On the CPU both packages score candidates with the one-pass ``gather``
engine (``band_dp_batch``) by default, and every output is exact, spans
included. The port's other engines run here through their plain versions:
``v3`` (two-pass: the forward pass keeps, among cells tied at the best
score, the lowest band offset) and ``dma`` (the fused-fetch kernel's
contract: per-cell first row, lowest band offset at the maximum). Against
the JAX run their scores, winners and counts are exact; their spans may
differ only where optimal alignments tie, and every differing span is
checked to be optimal.
"""

import importlib
import inspect
import re

import numpy as np
import pytest
import torch

from svjedi_tpu.align import device as jdev
from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.config import resolve_min_count_density
from svjedi_tpu.io import sim
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align import pipeline as tpipe

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
WINNER_FIELDS = ("read", "cluster", "path", "strand", "score", "qs", "qe",
                 "ts", "te", "mapq", "anchor_ts", "anchor_te")
COPIED = (
    "Winners", "_malloc_trim", "revcomp_codes", "_pick_bucket",
    "candidate_windows", "candidate_layout", "compute_mapq", "finalize_chunk",
    "prune_secondaries", "cross_cluster_prune", "count_support", "_audit_line",
    "_chunk_device_bytes",
)


def _inputs(pkg: str, tmp, chroms):
    """Panel, indexes, configs and reads built by package ``pkg``'s own host
    modules from the same files: the port's functions get the port's types
    (``align_and_count`` tells a ``ReadSet`` from a stream by its class)."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    config = mod("config")
    cfg = config.AlignConfig()
    parsed = mod("graph.svparse").parse_vcf_svs(
        tmp / "truth.vcf", {c: len(x) for c, x in chroms.items()})
    panel = mod("graph.cluster").build_panel(
        mod("graph.build").build_graph(chroms, parsed), flank=cfg.flank,
        cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
        max_hops_per_path=cfg.max_hops_per_path,
    )
    hits = cfg.max_hits_per_minimizer
    index = mod("align.index").build_panel_index(
        panel, k=cfg.kmer, w=cfg.window, max_hits_per_minimizer=hits)
    decoy = mod("align.decoy").build_decoy(
        panel, k=cfg.kmer, w=cfg.window, max_hits_per_minimizer=hits)
    return {
        "panel": panel, "index": index, "decoy": decoy, "cfg": cfg,
        "gcfg": config.GenotypeConfig(),
        "reads": mod("io.fastq").read_reads(str(tmp / "reads.fastq")),
        "seed": mod("align.seed"),
    }


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """Two chromosomes, 8 DEL/INS/INV, ~12x of 3 kb reads, decoy on; the
    inputs of each package built by its own host modules."""
    tmp = tmp_path_factory.mktemp("torch_align")
    s = sim.simulate(
        seed=11, chrom_lengths={"chrA": 32000, "chrB": 26000}, n_svs=8,
        sv_types=("DEL", "INS", "INV"),
    )
    names, seqs = sim.simulate_reads(
        np.random.default_rng(11), s.haplotypes, coverage=12.0,
        mean_len=3000, sd_len=1000,
    )
    sim.write_truth_vcf(s, tmp / "truth.vcf")
    sim.write_fastq(tmp / "reads.fastq", names, seqs)
    return {pkg: _inputs(pkg, tmp, s.chroms)
            for pkg in ("svjedi_tpu", "svjedi_tpu_torch")}


def _args(b):
    return b["reads"], b["panel"], b["index"], b["cfg"], b["gcfg"]


@pytest.fixture(scope="module")
def runs(bundle):
    j, t = bundle["svjedi_tpu"], bundle["svjedi_tpu_torch"]
    return (jpipe.align_and_count(*_args(j), decoy=j["decoy"]),
            tpipe.align_and_count(*_args(t), decoy=t["decoy"], device=CPU))


def test_port_inputs_are_the_ports_own_types(bundle):
    """Each side's inputs come from its own package and hold equal data."""
    j, t = bundle["svjedi_tpu"], bundle["svjedi_tpu_torch"]
    assert isinstance(t["reads"], tpipe.ReadSet)
    assert not isinstance(j["reads"], tpipe.ReadSet)
    assert type(t["panel"]).__module__ == "svjedi_tpu_torch.graph.cluster"
    assert type(t["index"]).__module__ == "svjedi_tpu_torch.align.index"
    np.testing.assert_array_equal(t["reads"].codes, j["reads"].codes)
    np.testing.assert_array_equal(t["index"].path_len, j["index"].path_len)
    assert t["cfg"] == tpipe.AlignConfig() and t["gcfg"] == tpipe.GenotypeConfig()


def test_align_and_count_matches_jax(runs):
    """The default engine on the CPU is the JAX CPU engine: all exact."""
    (jcounts, jaudit, jw), (tcounts, taudit, tw) = runs
    assert len(tw.read) == len(jw.read) > 50
    for f in WINNER_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
    assert tcounts == jcounts
    assert taudit == jaudit
    assert sum(v[0] + v[1] for v in tcounts.values()) > 0


@pytest.mark.parametrize("engine", ["v3", "dma"])
def test_align_and_count_engine_matches_jax(bundle, runs, engine):
    """Scores, winners and counts exact; spans may move among optimal ties
    (checked optimal per block in test_chunk_spans_are_optimal and
    test_chunk_onepass_engines_match_jax)."""
    jcounts, _, jw = runs[0]
    t = bundle["svjedi_tpu_torch"]
    tcounts, _, tw = tpipe.align_and_count(*_args(t), decoy=t["decoy"],
                                           device=CPU, engine=engine)
    assert len(tw.read) == len(jw.read) > 50
    for f in ("read", "cluster", "path", "strand", "score", "mapq"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
    same = np.ones(len(jw.read), dtype=bool)
    for f in ("qs", "qe", "ts", "te"):
        same &= getattr(tw, f) == getattr(jw, f)
    assert same.mean() >= 0.9
    assert tcounts == jcounts


def _seed(b):
    cfg, seed = b["cfg"], b["seed"]
    params = seed.ChainParams(
        min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
        max_gap=cfg.chain_max_gap, drift_abs=cfg.chain_drift_abs,
        drift_permille=cfg.chain_drift_permille, block_rows=cfg.block_rows,
        ext_min_anchors=cfg.chain_ext_min_anchors,
    )
    return seed.seed_candidates(b["reads"], b["index"], chain_params=params)


def _t(bundle, *keys):
    return (bundle["svjedi_tpu_torch"][k] for k in keys)


@pytest.fixture(scope="module")
def chunk(bundle):
    """One chunk, seeded once by each package, through the JAX and the port
    dispatch; the two packages' candidates are equal."""
    j, t = bundle["svjedi_tpu"], bundle["svjedi_tpu_torch"]
    jcands, cands = _seed(j), _seed(t)
    for f in ("read", "path", "strand", "d0"):
        np.testing.assert_array_equal(getattr(cands, f), getattr(jcands, f))
    jdisp = jpipe.dispatch_chunk(
        j["reads"], j["panel"], j["index"], jcands, j["cfg"],
        jdev.upload(j["reads"].codes, j["panel"]))
    (jrows,) = jpipe.collect_outs([jdisp])
    tdisp = tpipe.dispatch_chunk(
        t["reads"], t["panel"], t["index"], cands, t["cfg"],
        tdev.upload(t["reads"].codes, t["panel"], CPU), engine="v3")
    (trows,) = tpipe.collect_outs([tdisp])
    return cands, jdisp, jrows, tdisp, trows


def _cand_rows(disp, host_rows, n):
    """Per-candidate one-pass results [score, qs, ts, qe, te] (-1: unscored)."""
    out = np.full((n, 5), -1, dtype=np.int64)
    for (sel, _, kind, _), host in zip(disp.batches, host_rows):
        assert kind == "full"
        out[sel] = host[: len(sel)]
    return out


@pytest.mark.parametrize("engine", [None, "dma"])
def test_chunk_onepass_engines_match_jax(bundle, chunk, engine):
    """The one-pass engines give "full" batches; the default engine's rows
    (gather on the CPU) equal the JAX CPU dispatch exactly, the dma rows
    have equal scores and optimal spans where they differ."""
    from _span_check import assert_spans_optimal

    reads, panel, index, cfg = _t(bundle, "reads", "panel", "index", "cfg")
    cands, jdisp, jrows, _, _ = chunk
    n = len(cands)
    disp = tpipe.dispatch_chunk(reads, panel, index, cands, cfg,
                                tdev.upload(reads.codes, panel, CPU),
                                engine=engine)
    (rows,) = tpipe.collect_outs([disp])
    got = _cand_rows(disp, rows, n)
    ref = _cand_rows(jdisp, jrows, n)
    np.testing.assert_array_equal(disp.bucket_of_cand, jdisp.bucket_of_cand)
    if engine != "dma":
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    diff = np.flatnonzero((got != ref).any(axis=1))
    assert len(diff) <= 0.1 * len(np.flatnonzero(disp.bucket_of_cand > 0))
    m = tpipe.candidate_windows(reads, index, cands, cfg)[2].astype(np.int32)
    for bucket in np.unique(disp.bucket_of_cand[diff]):
        cand = diff[disp.bucket_of_cand[diff] == bucket]
        q, t = _windows(disp, cand, m[cand], int(bucket), cfg)
        span = dict(zip(tdev.OUT_COLS, got[cand].T))
        assert_spans_optimal(q, t, cfg.band, JaxDPParams(), span,
                             np.arange(len(cand)))


def _windows(disp, cand, m, bucket, cfg):
    """(q, t) window rows of candidates ``cand`` in ``bucket``-row windows."""
    meta = np.stack([disp.q_start[cand], m, disp.t_start[cand],
                     disp.t_lo[cand], disp.t_hi[cand]]).astype(np.int32)
    qT, tT = tdev._prep_v3_windows_packed(
        *disp.device_data.packed_words(), torch.from_numpy(meta), bucket,
        cfg.band,
    )
    return qT.T.numpy().copy(), tT.T.numpy().copy()


def test_chunk_spans_are_optimal(bundle, chunk):
    from _span_check import assert_spans_optimal

    j = bundle["svjedi_tpu"]
    reads, index, cfg = _t(bundle, "reads", "index", "cfg")
    cands, jdisp, jrows, tdisp, trows = chunk
    n = len(cands)
    # One-pass window coordinates per candidate: [score, qs, ts, qe, te].
    jwin = np.full((n, 5), -1, dtype=np.int64)
    for (sel, _, _, _), host in zip(jdisp.batches, jrows):
        jwin[sel] = host[: len(sel)]
    jw, jwi = jpipe.finalize_chunk(j["reads"], j["index"], j["cfg"], jdisp, jrows)
    tw, twi = tpipe.finalize_chunk(reads, index, cfg, tdisp, trows)
    np.testing.assert_array_equal(tdisp.block_score, jdisp.block_score)
    np.testing.assert_array_equal(twi, jwi)
    for f in ("read", "cluster", "path", "strand", "score"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f))

    # Forward ends that differ must end an optimal alignment.
    m = tpipe.candidate_windows(reads, index, cands, cfg)[2].astype(np.int32)
    scored = np.flatnonzero(tdisp.bucket_of_cand > 0)
    diff = scored[(tdisp.qe_win[scored] != jwin[scored, 3])
                  | (tdisp.te_win[scored] != jwin[scored, 4])]
    assert len(diff) <= 0.1 * len(scored)
    for bucket in np.unique(tdisp.bucket_of_cand[diff]):
        cand = diff[tdisp.bucket_of_cand[diff] == bucket]
        q, t = _windows(tdisp, cand, m[cand], int(bucket), cfg)
        zeros = np.zeros(len(cand), np.int64)
        out = {"score": tdisp.block_score[cand], "qs": zeros, "ts": zeros,
               "qe": tdisp.qe_win[cand], "te": tdisp.te_win[cand]}
        assert_spans_optimal(q, t, cfg.band, JaxDPParams(), out,
                             np.arange(len(cand)))

    # Reverse-pass starts: every winner's first-block span is optimal.
    tpipe.dispatch_rev(cfg, tdisp, tw, twi)
    (rev_rows,) = tpipe.collect_rev([tdisp])
    tpipe.patch_rev(cfg, tdisp, tw, rev_rows)
    t_rel = (cands.d0[twi].astype(np.int64) + tdisp.rw_start[twi]
             - cfg.band // 2)
    span = {
        "score": tdisp.block_score[twi],
        "qs": tw.qs - tdisp.rw_start[twi], "ts": tw.ts - t_rel,
        "qe": tdisp.qe_win[twi], "te": tdisp.te_win[twi],
    }
    for bucket in np.unique(tdisp.bucket_of_cand[twi]):
        rows = np.flatnonzero(tdisp.bucket_of_cand[twi] == bucket)
        q, t = _windows(tdisp, twi[rows], m[twi[rows]], int(bucket), cfg)
        assert_spans_optimal(q, t, cfg.band, JaxDPParams(),
                             {k: v[rows] for k, v in span.items()},
                             np.arange(len(rows)))
    same = (tw.qs == jwin[twi, 1] + tdisp.rw_start[twi])
    assert same.mean() >= 0.9


def test_resolve_engine_follows_the_jax_rule():
    assert tpipe.resolve_engine(None, CPU) == "gather"
    assert tpipe.resolve_engine(None, torch.device("cuda:0")) == "v3"
    for engine in tpipe.ENGINES:
        assert tpipe.resolve_engine(engine, CPU) == engine
    with pytest.raises(ValueError, match="engine"):
        tpipe.resolve_engine("pallas", CPU)


@pytest.mark.parametrize("name", COPIED)
def test_copied_helper_source_is_verbatim(name):
    ours = inspect.getsource(getattr(tpipe, name))
    theirs = inspect.getsource(getattr(jpipe, name))
    assert ours == theirs
    src = inspect.getsource(tpipe)
    assert re.search(
        rf"# Copied verbatim from svjedi_tpu/align/pipeline.py:{name}\.", src
    )


def test_copied_helpers_behave_like_originals(bundle, chunk):
    """Each package's helper on its own inputs; the dispatch layout (plain
    arrays) is the JAX run's, so both helpers see the same candidates."""
    j = bundle["svjedi_tpu"]
    reads, panel, index, cfg = _t(bundle, "reads", "panel", "index", "cfg")
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, 500).astype(np.int8)
    np.testing.assert_array_equal(tpipe.revcomp_codes(codes),
                                  jpipe.revcomp_codes(codes))
    for m in (0, 512, 513, 30720, 40000):
        assert tpipe._pick_bucket(m, cfg.buckets) == jpipe._pick_bucket(m, cfg.buckets)
    for nb in (1, 4096, 5000, 1 << 20):
        assert tpipe._chunk_device_bytes(nb) == jpipe._chunk_device_bytes(nb)
    tpipe._malloc_trim()
    args = [rng.integers(0, 400, 64) for _ in range(5)]
    np.testing.assert_array_equal(tpipe.compute_mapq(*args),
                                  jpipe.compute_mapq(*args))

    cands, jdisp, jrows, _, _ = chunk
    jcands = _seed(j)
    jargs = (j["reads"], j["index"], jcands, j["cfg"])
    for a, b in zip(tpipe.candidate_windows(reads, index, cands, cfg),
                    jpipe.candidate_windows(*jargs)):
        np.testing.assert_array_equal(a, b)
    dd = jdisp.device_data
    for a, b in zip(tpipe.candidate_layout(reads, index, cands, cfg, dd),
                    jpipe.candidate_layout(*jargs, dd)):
        np.testing.assert_array_equal(a, b)

    jw, jwi = jpipe.finalize_chunk(j["reads"], j["index"], j["cfg"], jdisp, jrows)
    tw, twi = tpipe.finalize_chunk(reads, index, cfg, jdisp, jrows)
    np.testing.assert_array_equal(twi, jwi)
    for f in WINNER_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
    jr = j["reads"]
    jw = jpipe.cross_cluster_prune(jpipe.prune_secondaries(jw, jr, j["cfg"]), jr)
    tw = tpipe.cross_cluster_prune(tpipe.prune_secondaries(tw, reads, cfg), reads)
    for f in WINNER_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
    density = resolve_min_count_density(j["gcfg"], j["cfg"])
    for w in (jw, tw):  # audit lines with and without the stats pass
        assert tpipe.count_support(panel, w, reads, 100, True, density) == \
            jpipe.count_support(j["panel"], w, jr, 100, True, density)
        jpipe.compute_winner_stats(jr, j["panel"], w, j["cfg"])


def test_compute_winner_stats_matches_jax(bundle, chunk):
    j = bundle["svjedi_tpu"]
    reads, panel, index, cfg = _t(bundle, "reads", "panel", "index", "cfg")
    _, jdisp, jrows, _, _ = chunk
    jw, _ = jpipe.finalize_chunk(j["reads"], j["index"], j["cfg"], jdisp, jrows)
    tw, _ = tpipe.finalize_chunk(reads, index, cfg, jdisp, jrows)
    jpipe.compute_winner_stats(j["reads"], j["panel"], jw, j["cfg"])
    tpipe.compute_winner_stats(reads, panel, tw, cfg, CPU)
    for f in ("matches", "blocklen", "rescore_deficit", "rescore_flag"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
