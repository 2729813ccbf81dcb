"""The port's mask_level elections (``align/pipeline.py:elect``) against the
JAX package's per-row loops, on adversarial synthetic rows.

``finalize_chunk``'s primary set, ``prune_secondaries`` and
``cross_cluster_prune`` each elect in numpy rounds; the JAX package's
functions of the same names walk their groups row by row. Every case
compares every winner field, ``win`` and their order, and checks that the
rounds are the most rows any group keeps. The real chunk's comparisons are
in ``tests/test_torch_align.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.align.seed import Candidates

FIELDS = ("read", "cluster", "path", "strand", "score", "qs", "qe", "ts",
          "te", "matches", "blocklen", "mapq", "anchor_ts", "anchor_te",
          "rescore_deficit", "rescore_flag")
CASES = ("ties", "spans01", "half", "cap", "paths", "rounds", "strands",
         "density", "empty")
#: paths per cluster (path p lies in cluster p // PATHS)
PATHS = 3


def _groups(sizes, n_clusters, rng):
    """(read, cluster) of each row, groups of ``sizes`` rows, no two groups
    alike, the rows of a group apart in the input order."""
    g = rng.permutation(len(sizes) * n_clusters)[:len(sizes)]
    read = np.repeat(g // n_clusters, sizes)
    cluster = np.repeat(g % n_clusters, sizes)
    perm = rng.permutation(len(read))
    return read[perm], cluster[perm]


def _case(name, seed):
    """Rows of one case: read, cluster, path, strand, score and the forward
    read interval [lo, hi) of each, the read lengths, and a target span."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        sizes = np.zeros(0, dtype=np.int64)
    elif name == "rounds":  # one group of 200 rows beside 300 singletons
        sizes = np.r_[200, np.ones(300, dtype=np.int64)]
    else:
        sizes = rng.integers(1, 14, 40)
    read, cluster = _groups(sizes, 6, rng)
    n = len(read)
    strand = rng.integers(0, 2, n)
    path = cluster * PATHS + rng.integers(0, PATHS, n)
    score = rng.integers(40, 400, n)
    lo = rng.integers(0, 60, n)
    length = rng.integers(0, 40, n)
    if name == "ties":  # equal scores and equal intervals
        score = rng.choice([80, 80, 120], n)
        lo = rng.choice([0, 10], n)
        length = rng.choice([20, 20, 7], n)
    elif name == "spans01":
        lo, length = rng.integers(0, 5, n), rng.integers(0, 2, n)
    elif name == "half":  # 2 ov == span on a small grid
        lo, length = rng.integers(0, 12, n) * 2, rng.integers(0, 12, n) * 2
        length[::3] += 1
    elif name == "cap":
        # Disjoint chains D0 > O0 > D1 > O1 > ... by score, each O_i on
        # D_i's path and interval: every O_i before the eighth kept D
        # raises D_i's s2, O_7 and later are never visited; X_i cover D_i
        # on another path.
        k = 20
        rows = np.arange(3 * k)
        d = rows % k
        kind = rows // k  # 0: D, 1: O, 2: X
        read = np.r_[read, np.full(3 * k, read.max() + 1)]
        cluster = np.r_[cluster, np.zeros(3 * k, dtype=np.int64)]
        strand = np.r_[strand, np.zeros(3 * k, dtype=np.int64)]
        path = np.r_[path, np.where(kind == 2, 1, 0)]
        score = np.r_[score, 10_000 - 10 * d - np.array([0, 5, 7])[kind]]
        lo = np.r_[lo, 100 * d + np.array([0, 2, 1])[kind]]
        length = np.r_[length, np.full(3 * k, 50)]
    elif name == "paths":  # a few paths, overlaps everywhere
        lo, length = rng.integers(0, 8, n), rng.integers(10, 20, n)
    elif name == "rounds":
        lo, length = rng.integers(0, 4000, n), rng.integers(1, 100, n)
    rlen = np.full(read.max() + 1 if len(read) else 0, 200)
    if name == "strands":
        rlen = rng.integers(100, 300, len(rlen))
    hi = lo + length
    if name == "rounds":
        rlen[:] = hi.max() + 1
    span = np.maximum(length, 1) + rng.integers(-3, 4, len(lo))
    if name == "density":  # around the floor: 500 per 1,000 bases
        score = span * rng.integers(400, 600, len(lo)) // 1000
    return dict(read=read, cluster=cluster, path=path, strand=strand,
                score=score, lo=lo, hi=hi, rlen=rlen, span=span)


def _reads(c):
    return SimpleNamespace(lengths=c["rlen"].astype(np.int64))


def _finalize_inputs(c, seed):
    """A chunk whose candidates are single-block chains with the case's
    anchor extents and scores, in random order, with one-pass rows."""
    n = len(c["read"])
    rlen = c["rlen"][c["read"]]
    fwd = c["strand"] == 0
    cands = Candidates(
        read=c["read"].astype(np.int32), path=c["path"].astype(np.int32),
        strand=c["strand"].astype(np.int8), d0=np.zeros(n, np.int32),
        n_anchors=np.random.default_rng(seed).integers(10, 30, n).astype(
            np.int32),
        a_lo=np.where(fwd, c["lo"], rlen - c["hi"]).astype(np.int32),
        a_hi=np.where(fwd, c["hi"], rlen - c["lo"]).astype(np.int32),
    )
    qs = np.where(fwd, c["lo"], rlen - c["hi"])
    host = np.stack([c["score"], qs, 1000 + qs, qs + c["span"],
                     1000 + qs + c["span"]], axis=1)
    n_paths = c["path"].max() + 1 if n else 1
    index = SimpleNamespace(
        path_cluster=(np.arange(n_paths) // PATHS).astype(np.int32))
    cfg = SimpleNamespace(band=128, min_score=40, diag_bin=16)

    def disp():
        return SimpleNamespace(
            cands=cands, rw_start=np.zeros(n, np.int64),
            batches=[(np.arange(n), None, "full", 512)])

    return index, cfg, disp, [host]


def _winners(pkg, c):
    """The case's rows as winners of ``pkg``, every optional field set."""
    rlen = c["rlen"][c["read"]]
    fwd = c["strand"] == 0
    n = len(c["read"])
    q_lo, q_hi = c["lo"], c["hi"] - 1  # closed
    w = pkg.Winners(
        read=c["read"].astype(np.int64), cluster=c["cluster"].astype(np.int64),
        path=c["path"].astype(np.int64), strand=c["strand"].astype(np.int64),
        score=c["score"].astype(np.int64),
        qs=np.where(fwd, q_lo, rlen - 1 - q_hi),
        qe=np.where(fwd, q_hi, rlen - 1 - q_lo),
        ts=np.full(n, 500, np.int64), te=500 + c["span"] - 1,
    )
    rng = np.random.default_rng(n)
    for f in FIELDS[9:]:
        setattr(w, f, rng.integers(0, 60, n))
    return w


def _assert_same(ours, theirs):
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _most_kept(*keys):
    """The most rows any group of the keys' rows holds (0 for none)."""
    if not len(keys[0]):
        return 0
    _, counts = np.unique(np.stack(keys), axis=1, return_counts=True)
    return int(counts.max())


@pytest.mark.parametrize("name", CASES)
def test_finalize_chunk_elects_as_jax(name):
    c = _case(name, 23)
    index, cfg, disp, rows = _finalize_inputs(c, 23)
    reads = _reads(c)
    tdisp, jdisp = disp(), disp()
    tw, twin = tpipe.finalize_chunk(reads, index, cfg, tdisp, rows)
    jw, jwin = jpipe.finalize_chunk(reads, index, cfg, jdisp, rows)
    np.testing.assert_array_equal(twin, jwin)
    _assert_same(tw, jw)
    alive = int((c["score"] >= cfg.min_score).sum())
    assert getattr(tdisp, "elect_rows", 0) == alive
    assert getattr(tdisp, "elect_rounds", 0) == min(
        8, _most_kept(tw.read, tw.cluster))
    if name == "cap":
        # The capped group keeps D0-D7 (score order), and only O0-O6
        # lowered their mapq: O7 came after the eighth kept chain.
        top = tw.read == c["read"].max()
        assert top.sum() == 8
        assert (tw.mapq[top][:7] < 60).all() and tw.mapq[top][7] == 60


@pytest.mark.parametrize("name", CASES)
def test_prune_secondaries_elects_as_jax(name):
    c = _case(name, 29)
    cfg = SimpleNamespace(min_density_millis=500)
    for with_cfg in (None, cfg):
        timings = {}
        ours = tpipe.prune_secondaries(_winners(tpipe, c), _reads(c),
                                       with_cfg, timings=timings)
        theirs = jpipe.prune_secondaries(_winners(jpipe, c), _reads(c),
                                         with_cfg)
        _assert_same(ours, theirs)
        assert timings.get("elect_rows", 0) == len(c["read"])
        assert timings.get("elect_rounds", 0) == _most_kept(ours.read,
                                                            ours.cluster)
    if name == "density":
        dense = c["score"] * 1000 >= cfg.min_density_millis * c["span"]
        assert 0 < dense.sum() < len(dense)


@pytest.mark.parametrize("name", CASES)
def test_cross_cluster_prune_elects_as_jax(name):
    c = _case(name, 31)
    timings = {}
    ours = tpipe.cross_cluster_prune(_winners(tpipe, c), _reads(c),
                                     timings=timings)
    theirs = jpipe.cross_cluster_prune(_winners(jpipe, c), _reads(c))
    _assert_same(ours, theirs)
    assert timings.get("elect_rows", 0) == len(c["read"])
    assert timings.get("elect_rounds", 0) == _most_kept(ours.read)


def test_prunes_keep_the_object_when_nothing_goes():
    """Both prunes hand back their input where they drop no row, as the
    JAX package's do."""
    c = _case("rounds", 3)
    c["lo"] = np.arange(len(c["read"])) * 100
    c["hi"] = c["lo"] + 10
    c["rlen"][:] = c["hi"].max() + 1
    w = _winners(tpipe, c)
    assert tpipe.cross_cluster_prune(w, _reads(c)) is w
    assert tpipe.prune_secondaries(w, _reads(c)) is w


def test_elect_rounds_follow_the_kept_rows():
    """A group of 1,000 rows that all mask each other takes one round; the
    cap stops a group of disjoint rows at its cap-th kept row, and the rows
    after it are not visited."""
    group = np.zeros(1000, dtype=np.int64)
    keep, blocker, rounds = tpipe.elect(group, np.zeros(1000),
                                        np.full(1000, 10))
    assert rounds == 1 and keep.sum() == 1
    np.testing.assert_array_equal(blocker[1:], 0)
    lo = np.repeat(np.arange(20) * 10, 2)  # pairs: a row, then its twin
    keep, blocker, rounds = tpipe.elect(np.zeros(40, np.int64), lo, lo + 5,
                                        cap=8)
    assert rounds == 8
    np.testing.assert_array_equal(np.flatnonzero(keep), np.arange(0, 16, 2))
    np.testing.assert_array_equal(blocker[1:15:2], np.arange(0, 14, 2))
    assert (blocker[15:] == -1).all()
