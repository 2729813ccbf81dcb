"""The port's per-chunk recovery (CPU): where the batched fetch of the
pending chunks' forward rows fails, ``align_and_count`` re-dispatches each
pending chunk from its kept candidates and runs the flush's tail on it
alone, with one retry; the counts, audit lines and winners equal a clean
run's. A fetch that keeps failing raises.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.align.index import build_panel_index
from svjedi_tpu_torch.config import AlignConfig, GenotypeConfig
from svjedi_tpu_torch.graph.build import build_graph
from svjedi_tpu_torch.graph.cluster import build_panel
from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
from svjedi_tpu_torch.io import sim
from svjedi_tpu_torch.io.fastq import ReadSet, encode_ascii

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: Two chunks (the first of 256 reads), fetched in one flush.
CHUNK_READS = 256
WINNER_FIELDS = ("read", "cluster", "path", "strand", "score", "qs", "qe",
                 "ts", "te", "matches", "blocklen", "mapq",
                 "rescore_deficit", "rescore_flag")


@pytest.fixture(scope="module")
def workload():
    """60 kb, 8 SVs, ~300 reads of ~600 b: panel, index, configs, reads."""
    rng = np.random.default_rng(4)
    s = sim.simulate(seed=6, chrom_lengths={"c1": 60_000}, n_svs=8)
    names, seqs = sim.simulate_reads(rng, s.haplotypes, coverage=3.0,
                                     mean_len=600, sd_len=60)
    with tempfile.TemporaryDirectory() as tmp:
        vcf = os.path.join(tmp, "t.vcf")
        sim.write_truth_vcf(s, vcf)
        parsed = parse_vcf_svs(vcf, {c: len(x) for c, x in s.chroms.items()})
    cfg = AlignConfig()
    panel = build_panel(build_graph(s.chroms, parsed), flank=cfg.flank,
                        cluster_gap=cfg.cluster_gap)
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in seqs])])
    reads = ReadSet(names=names,
                    codes=np.concatenate([encode_ascii(x) for x in seqs]),
                    offsets=offsets.astype(np.int64))
    assert reads.n_reads > CHUNK_READS
    return reads, panel, index, cfg, GenotypeConfig()


def _run(workload, timings=None, n_reads=None, engine=None):
    reads, panel, index, cfg, gcfg = workload
    if n_reads is not None:
        reads = reads.slice(0, n_reads)
    return tpipe.align_and_count(reads, panel, index, cfg, gcfg, device=CPU,
                                 collect_audit=True, timings=timings,
                                 chunk_reads=CHUNK_READS, engine=engine)


@pytest.mark.parametrize("engine", ["gather", "v3"])
def test_bulk_fetch_failure_recovers_per_chunk(workload, engine, monkeypatch,
                                               capsys):
    """``gather`` is the CPU's default; ``v3`` adds the reverse pass to the
    flush's tail."""
    clean = _run(workload, engine=engine)
    real = tpipe.collect_outs
    calls = []

    def flaky(dispatches):
        calls.append(len(dispatches))
        if len(calls) == 1:
            raise RuntimeError("injected fetch failure")
        return real(dispatches)

    monkeypatch.setattr(tpipe, "collect_outs", flaky)
    timings = {}
    counts, audit, winners = _run(workload, timings, engine=engine)
    assert calls == [2, 1, 1]  # the bulk fetch, then each chunk alone
    assert list(counts.items()) == list(clean[0].items())
    assert list(audit.items()) == list(clean[1].items())
    assert counts and audit
    for f in WINNER_FIELDS:
        np.testing.assert_array_equal(getattr(winners, f),
                                      getattr(clean[2], f), err_msg=f)
    assert timings["n_retries"] >= 1 and timings["n_chunks"] == 2
    assert timings["audit_pieces"] > 0 and timings["count_s"] > 0
    assert (timings["rev_problems"] > 0) == (engine == "v3")
    assert "per-chunk recovery" in capsys.readouterr().err


def test_persistent_failure_raises(workload, monkeypatch):
    def dead(dispatches):
        raise RuntimeError("device gone")

    monkeypatch.setattr(tpipe, "collect_outs", dead)
    with pytest.raises(RuntimeError, match="device gone"):
        _run(workload, n_reads=64)  # one chunk
