"""The audit re-score's stats DP (A1) of the port vs the JAX package.

``svjedi_tpu_torch.align.extend.band_dp_stats_batch`` (on the CPU: the
plain version ``kernels/band_dp_stats.py:band_dp_stats_ref``) must equal
``svjedi_tpu.align.extend.band_dp_stats_batch`` (XLA on the CPU) exactly on
all five outputs: at the audit's bands (256, and 512 for ``cfg.band`` 256)
and buckets, on ragged pieces, tied maxima, inputs where the (score, row)
end rule and the one-pass kernels' per-cell rule part, and scores at which
every row must run. A numpy model of the kernel's row skip is held to JAX
too, and so is ``compute_winner_stats``, in which the DP fetches its
windows from the chunk's uploaded buffers (``band_dp_stats_flat``; on the
CPU a gather and the plain version), with whole-bucket and sliced
batches and at several piece lengths: its vectorised piece table equals
the per-piece loop it replaced, and the fetch equals windows cut by hand
from the buffers.
The CUDA kernel is held against its plain version on the card
(``chip_smoke.py`` phase 2e and the gpu-marked tests at the end).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import band_dp_stats_batch as jax_stats
from svjedi_tpu.config import AlignConfig as JaxAlignConfig
from svjedi_tpu.io.fastq import ReadSet as JaxReadSet
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.align.extend import (
    DPParams, _band_dp_rows, band_dp_stats_batch,
)
from svjedi_tpu_torch.config import AlignConfig
from svjedi_tpu_torch.io.fastq import ReadSet
from svjedi_tpu_torch.kernels import band_dp_stats as a1
from svjedi_tpu_torch.kernels.band_dp import rows_skip_exact

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

KEYS = a1.STATS_COLS
CPU = torch.device("cpu")


def _pieces(seed: int, P: int, M: int, band: int):
    """Audit-like pieces: a read window of m <= M bases (ragged, sentinel
    rows after it) and the target window holding a noisy copy of it
    (substitutions, indels) near the band's centre; then the edge and
    tie-heavy cases: an all-sentinel read row, an all-sentinel target,
    poly-A against poly-A, and di- and trinucleotide tandem repeats."""
    rng = np.random.default_rng(seed)
    q = np.full((P, M), 4, dtype=np.int8)
    t = np.full((P, M + band), 4, dtype=np.int8)
    for p in range(P):
        m = int(rng.integers(M // 4, M + 1))
        read = rng.integers(0, 4, m).astype(np.int8)
        read[rng.random(m) < 0.01] = 4
        q[p, :m] = read
        copy = np.where(read == 4, rng.integers(0, 4, m), read).astype(np.int8)
        flips = rng.random(m) < 0.1
        copy[flips] = rng.integers(0, 4, int(flips.sum()))
        copy = np.delete(copy, rng.integers(0, m, 3))
        copy = np.insert(copy, rng.integers(0, len(copy), 3),
                         rng.integers(0, 4, 3).astype(np.int8))
        off = band // 2 + int(rng.integers(-20, 21))
        n = min(len(copy), M + band - off)
        t[p, off : off + n] = copy[:n]
    q[0] = 4
    t[1] = 4
    q[2], t[2] = 0, 0
    q[3], t[3] = np.resize([0, 1], M), np.resize([0, 1], M + band)
    q[4], t[4] = np.resize([2, 0, 3], M), np.resize([1, 2, 0, 3], M + band)
    return q, t


def _two_local_alignments(M: int, band: int):
    """One problem where the row end rule and the per-cell rule part: two
    separate local alignments of equal score, the first ending at an early
    row on a high band offset, the second at a later row on a low one (the
    gap between their diagonals costs more than either scores)."""
    rng = np.random.default_rng(5)
    x, y = (rng.integers(0, 4, 30).astype(np.int8) for _ in range(2))
    q = np.full((1, M), 4, dtype=np.int8)
    t = np.full((1, M + band), 4, dtype=np.int8)
    k_hi, k_lo = band - 28, 20
    q[0, :30] = x
    t[0, k_hi : k_hi + 30] = x
    q[0, 40:70] = y
    t[0, 40 + k_lo : 70 + k_lo] = y
    return q, t


def _jax(q, t, band, params=DPParams()):
    jp = JaxDPParams(params.match, params.mismatch, params.gap_open,
                     params.gap_extend)
    return {k: np.asarray(v) for k, v in jax_stats(q, t, band, jp).items()}


def _assert_equal(got, ref):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]), ref[key],
                                      err_msg=key)


@pytest.mark.parametrize("band, M, P", [(256, 512, 8), (256, 1024, 6),
                                        (256, 2048, 6), (512, 2048, 6)])
def test_stats_matches_jax(band, M, P):
    q, t = _pieces(M + band, P, M, band)
    ref = _jax(q, t, band)
    launches = a1.launches
    got = band_dp_stats_batch(torch.from_numpy(q), torch.from_numpy(t), band)
    assert a1.launches == launches  # the plain version launches nothing
    _assert_equal({k: v.numpy() for k, v in got.items()}, ref)
    _assert_equal(a1.band_dp_stats_ref(torch.from_numpy(q),
                                       torch.from_numpy(t), band), ref)
    assert tuple(int(ref[k][0]) for k in KEYS) == (0, 0, 0, -1, -1)
    assert tuple(int(ref[k][1]) for k in KEYS) == (0, 0, 0, -1, -1)
    assert (ref["matches"][5:] > 0).all() and (ref["n_diag"] >= ref["matches"]).all()


@pytest.mark.parametrize("band", [256, 512])
def test_end_is_the_row_rule_not_the_per_cell_rule(band):
    """The end is the first row whose maximum beats the best, then the
    lowest offset in that row; the one-pass kernels' per-cell rule would
    report the later alignment."""
    M = 128
    q, t = _two_local_alignments(M, band)
    ref = _jax(q, t, band)
    assert int(ref["score"][0]) == 60 and int(ref["qe"][0]) == 29
    assert int(ref["te"][0]) == 29 + band - 28
    got = band_dp_stats_batch(torch.from_numpy(q), torch.from_numpy(t), band)
    _assert_equal({k: v.numpy() for k, v in got.items()}, ref)
    zeros = torch.zeros((2, 1, band), dtype=torch.int32)
    per_cell = _band_dp_rows(
        torch.from_numpy(q), torch.from_numpy(t), band, DPParams(), zeros,
        lambda m: torch.stack([m.to(torch.int32), torch.ones_like(zeros[0])]),
        lambda i: zeros, per_cell=True)
    assert int(per_cell[0][0]) == 60 and int(per_cell[2][0]) == 69


#: Scores at which trailing sentinel rows may move the result, so the
#: kernel runs every row: a zero gap open (open + extend 0) and a positive
#: mismatch.
EVERY_ROW = {"oe=0": dict(gap_open=2, gap_extend=-2),
             "mismatch=1": dict(mismatch=1)}


@pytest.mark.parametrize("scores", EVERY_ROW.values(), ids=EVERY_ROW.keys())
@pytest.mark.parametrize("band", [256, 512])
def test_stats_with_every_row_scores_matches_jax(scores, band):
    params = DPParams(**scores)
    assert not rows_skip_exact(params)
    q, t = _pieces(71, 6, 512, band)
    ref = _jax(q, t, band, params)
    got = band_dp_stats_batch(torch.from_numpy(q), torch.from_numpy(t), band,
                              params)
    _assert_equal({k: v.numpy() for k, v in got.items()}, ref)


#: Scores where rows_skip_exact holds.
SKIP_SCORES = {"defaults": {}, "mismatch=0": dict(mismatch=0),
               "gap_extend=0": dict(gap_extend=0),
               "oe=-1": dict(gap_open=-1, gap_extend=0)}


def _kernel_rows(q: np.ndarray, band: int) -> np.ndarray:
    """The rows the kernel runs for each problem where it may skip: up to
    its last non-sentinel read row, rounded up to the cells per lane (the
    warp's maximum is at least that)."""
    M = q.shape[1]
    coded = q[:, ::-1] != 4
    rows = np.where(coded.any(axis=1), M - coded.argmax(axis=1), 0)
    cells = 16 if band == 512 else 8
    return (rows + cells - 1) // cells * cells


@pytest.mark.parametrize("scores", SKIP_SCORES.values(),
                         ids=SKIP_SCORES.keys())
@pytest.mark.parametrize("band", [256, 512])
def test_row_skip_model_matches_jax_full_rows(scores, band):
    """Each problem cut to the rows the kernel runs (its last non-sentinel
    row + 1, rounded up) equals JAX's result over every row, wherever
    rows_skip_exact holds; a problem with no coded row scores 0."""
    params = DPParams(**scores)
    assert rows_skip_exact(params)
    M, P = 512, 8
    q, t = _pieces(83, P, M, band)
    ends = np.random.default_rng(84).integers(M // 4, M // 2 + 1, P)
    q[np.arange(M)[None, :] >= ends[:, None]] = 4
    ref = _jax(q, t, band, params)
    rows = _kernel_rows(q, band)
    assert rows.max() < M and rows[0] == 0
    cut = {k: np.zeros(P, np.int32) for k in KEYS}
    cut["qe"][:] = cut["te"][:] = -1
    for r in np.unique(rows[rows > 0]):
        sel = rows == r
        out = a1.band_dp_stats_ref(torch.from_numpy(q[sel, :r].copy()),
                                   torch.from_numpy(t[sel, : r + band].copy()),
                                   band, params)
        for k in KEYS:
            cut[k][sel] = out[k].numpy()
    _assert_equal(cut, ref)


def test_packed_rider_and_kernel_shape_checks():
    a1.check_rider(65535)
    with pytest.raises(ValueError, match="M < 65536"):
        a1.check_rider(65536)
    with pytest.raises(ValueError, match="M < 65536"):
        a1.band_dp_stats(torch.full((1, 65536), 4, dtype=torch.int8),
                         torch.full((1, 65536 + 256), 4, dtype=torch.int8),
                         256)
    for band in a1.KERNEL_BANDS:
        a1.check_kernel_shape(band, 2048)
    with pytest.raises(ValueError, match="128, 256 or 512"):
        a1.check_kernel_shape(384, 2048)
    with pytest.raises(ValueError, match="multiple of 16"):
        a1.check_kernel_shape(512, 1032)
    with pytest.raises(ValueError, match="multiple of 8"):
        a1.check_kernel_shape(256, 1028)
    q = torch.full((4, 64), 4, dtype=torch.int8)
    t = torch.full((4, 320), 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="expected t"):
        a1.band_dp_stats(q, t[:, :300], 256)
    with pytest.raises(TypeError):
        a1.band_dp_stats(q.int(), t.int(), 256)
    with pytest.raises(ValueError, match="unsupported device"):
        a1.band_dp_stats(q.to("meta"), t.to("meta"), 256)


def _audit_case(pkg_readset, pkg_winners):
    """Reads that are noisy copies (indels included) of stretches of four
    panel paths, half of them reverse-complemented, and one winner per read
    whose span covers the copy; pieces fall into buckets 512 and 1024 at
    block_rows 700."""
    rng = np.random.default_rng(21)
    paths = [rng.integers(0, 4, 6000).astype(np.int8) for _ in range(4)]
    panel = SimpleNamespace(paths=[SimpleNamespace(seq=s, length=len(s))
                                   for s in paths])
    reads, fields = [], {k: [] for k in ("path", "strand", "qs", "qe", "ts",
                                         "te", "score")}
    for r in range(10):
        pi = int(rng.integers(0, 4))
        n = int(rng.integers(300, 1800))
        ts = int(rng.integers(0, 6000 - n))
        copy = paths[pi][ts : ts + n].copy()
        flips = rng.random(n) < 0.08
        copy[flips] = rng.integers(0, 4, int(flips.sum()))
        copy = np.insert(np.delete(copy, rng.integers(0, n, 6)),
                         rng.integers(0, n - 6, 6),
                         rng.integers(0, 4, 6).astype(np.int8))
        strand = r % 2
        oriented = copy
        read = copy if strand == 0 else np.where(copy < 4, 3 - copy,
                                                 copy)[::-1].astype(np.int8)
        reads.append(read)
        fields["path"].append(pi)
        fields["strand"].append(strand)
        fields["qs"].append(3)
        fields["qe"].append(len(oriented) - 4)
        fields["ts"].append(ts + 2)
        fields["te"].append(ts + n - 3)
        fields["score"].append(int(1.5 * n))
    codes = np.concatenate(reads)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in reads])])
    rs = pkg_readset(names=[f"r{i}" for i in range(len(reads))], codes=codes,
                     offsets=offsets.astype(np.int64))
    n = len(reads)
    w = pkg_winners(read=np.arange(n), cluster=np.zeros(n, np.int64),
                    **{k: np.asarray(v, np.int64) for k, v in fields.items()})
    return rs, panel, w


def _sliced_flat(pieces):
    """The fused-fetch stats DP run on column slices of ``pieces`` pieces,
    results rejoined; ``.seen`` collects the pieces of each call."""
    real = a1.band_dp_stats_flat

    def flat(reads2, panel_padded, cols, bucket, band, params):
        flat.seen.append(cols.shape[1])
        outs = [real(reads2, panel_padded,
                     cols[:, lo:lo + pieces].contiguous(), bucket, band,
                     params)
                for lo in range(0, cols.shape[1], pieces)]
        return {k: torch.cat([o[k] for o in outs]) for k in KEYS}
    flat.seen = []
    return flat


@pytest.mark.parametrize("pieces", [None, 4096, 3])
def test_compute_winner_stats_batching_matches_jax(pieces, monkeypatch):
    """Whole-bucket calls (``compute_winner_stats``'s rule), 4,096-piece
    calls (the JAX package's slices) and 3-piece calls all give JAX's
    4,096-piece result."""
    if pieces is not None:
        sliced = _sliced_flat(pieces)
        monkeypatch.setattr(a1, "band_dp_stats_flat", sliced)
    jrs, panel, jw = _audit_case(JaxReadSet, jpipe.Winners)
    trs, _, tw = _audit_case(ReadSet, tpipe.Winners)
    jpipe.compute_winner_stats(jrs, panel, jw, JaxAlignConfig(block_rows=700))
    timings = {}
    launches = a1.launches
    tpipe.compute_winner_stats(trs, panel, tw, AlignConfig(block_rows=700),
                               tdev.upload(trs.codes, panel, CPU),
                               timings=timings)
    assert a1.launches == launches
    if pieces is not None:
        assert sum(sliced.seen) == timings["audit_pieces"]
    assert timings["audit_assembly_s"] > 0 and timings["audit_dp_s"] > 0
    assert (jw.matches > 0).all()
    for f in ("matches", "blocklen", "rescore_deficit", "rescore_flag"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f),
                                      err_msg=f)


def _loop_piece_table(winners, block_rows: int, band: int):
    """The per-winner, per-piece loop that built ``compute_winner_stats``'
    piece table before :func:`tpipe.audit_piece_table`: the reference."""
    tspan = (winners.te - winners.ts + 1).astype(np.int64)
    p_win, p_a, p_b, p_t0 = [], [], [], []
    for wi in range(len(winners.qs)):
        qs, qe = int(winners.qs[wi]), int(winners.qe[wi])
        ts = int(winners.ts[wi])
        rows = qe - qs + 1
        if rows <= 0:
            continue
        for a in range(qs, qe + 1, block_rows):
            b = min(a + block_rows, qe + 1)
            t_a = ts + round((a - qs) * int(tspan[wi]) / rows)
            p_win.append(wi)
            p_a.append(a)
            p_b.append(b)
            p_t0.append(t_a - band // 2)
    return tuple(np.asarray(x, np.int64) for x in (p_win, p_a, p_b, p_t0))


@pytest.mark.parametrize("block_rows", [1, 3, 700, 1536])
def test_audit_piece_table_equals_the_loop(block_rows):
    """Random spans, a last piece shorter than ``block_rows``, winners with
    no rows (qe < qs) and spans whose interpolated start falls exactly half
    way between two positions, where both round half to even."""
    rng = np.random.default_rng(block_rows)
    n = 300
    qs = rng.integers(0, 20000, n)
    rows = rng.integers(1, 6000, n)
    rows[:40] = rng.integers(-3, 1, 40)  # no rows: no piece
    ts = rng.integers(-400, 20000, n)
    tspan = rng.integers(1, 6000, n)
    # Ties: row a = qs + j * block_rows lands at ts + j * tspan / 4, a half
    # for odd j when tspan is 2 mod 4.
    tie = slice(40, 80)
    rows[tie] = 4 * block_rows
    tspan[tie] = 4 * rng.integers(0, 500, 40) + 2
    w = SimpleNamespace(qs=qs, qe=qs + rows - 1, ts=ts, te=ts + tspan - 1)
    got = tpipe.audit_piece_table(w, block_rows, 256)
    ref = _loop_piece_table(w, block_rows, 256)
    for g, r, name in zip(got, ref, ("winner", "a", "b", "t0")):
        assert g.dtype == np.int64, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    win, a, b = ref[:3]
    halves = ((a - qs[win]) * tspan[win] * 2) % rows[win] == 0
    assert (halves & ((a - qs[win]) * tspan[win] % rows[win] != 0)).sum() > 10
    assert block_rows == 1 or ((b - a) < block_rows).any()
    assert len(win) > 200
    assert not np.isin(np.arange(40), win).any()


def test_pick_buckets_equals_pick_bucket():
    buckets = AlignConfig().buckets
    m = np.concatenate([np.arange(0, 40000, 7), np.asarray(buckets),
                        np.asarray(buckets) + 1])
    np.testing.assert_array_equal(
        tpipe.pick_buckets(m, buckets),
        [tpipe._pick_bucket(int(v), buckets) for v in m])


@pytest.mark.parametrize("block_rows", [250, 700, 1536])
def test_compute_winner_stats_fused_matches_jax(block_rows):
    """With the chunk's buffers the DP fetches every piece from them (both
    strands: half the reads are reverse-complemented), and the audit's
    fields equal JAX's, also where the winners are cut into many short
    pieces."""
    jrs, panel, jw = _audit_case(JaxReadSet, jpipe.Winners)
    jpipe.compute_winner_stats(jrs, panel, jw,
                               JaxAlignConfig(block_rows=block_rows))
    trs, _, tw = _audit_case(ReadSet, tpipe.Winners)
    timings = {}
    tpipe.compute_winner_stats(trs, panel, tw,
                               AlignConfig(block_rows=block_rows),
                               tdev.upload(trs.codes, panel, CPU),
                               timings=timings)
    assert timings["audit_pieces"] > len(tw.read) or block_rows == 1536
    for f in ("matches", "blocklen", "rescore_deficit", "rescore_flag"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f),
                                      err_msg=f)


def _flat_case(seed: int, M: int, band: int):
    """Flat buffers holding audit-like pieces (``_pieces`` and the two
    equal local alignments) between random codes, and per piece the five
    offsets of ``a1.PIECE_ROWS``: ragged m (0, and past the bucket too),
    clamps of the target inside and around its window, an empty target
    range, and windows reaching past either end of both buffers. Returns
    (reads2, panel, pieces, q, t), q and t the windows cut by hand."""
    rng = np.random.default_rng(seed)
    q, t = _pieces(seed, 24, M, band)
    q2, t2 = _two_local_alignments(M, band)
    q, t = np.concatenate([q, q2]), np.concatenate([t, t2])
    P, W = len(q), M + band
    reads2 = np.concatenate([rng.integers(0, 5, 100), q.reshape(-1),
                             rng.integers(0, 5, 100)]).astype(np.int8)
    panel = np.concatenate([rng.integers(0, 5, 300), t.reshape(-1),
                            rng.integers(0, 5, 300)]).astype(np.int8)
    q_start = 100 + M * np.arange(P)
    m = rng.integers(0, M + 1, P)
    m[:4] = (M, 0, M + 40, M)
    t_start = 300 + W * np.arange(P)
    t_lo = t_start + rng.integers(-60, 80, P)
    t_hi = t_start + W - rng.integers(-60, 80, P)
    t_lo[:3], t_hi[:3] = t_start[:3], t_start[:3] + W
    t_hi[4] = t_lo[4] - 1
    q_start[5], t_start[5] = -7, -9
    t_lo[5] = -20
    q_start[6], t_start[6] = len(reads2) - 50, len(panel) - 70
    t_hi[6] = len(panel) + 100
    pieces = a1.pack_pieces(q_start, t_start, m, t_lo, t_hi)
    qw = np.full((P, M), 4, np.int8)
    tw = np.full((P, W), 4, np.int8)
    for p in range(P):
        for i in range(min(m[p], M)):
            if 0 <= q_start[p] + i < len(reads2):
                qw[p, i] = reads2[q_start[p] + i]
        for j in range(W):
            pos = t_start[p] + j
            if t_lo[p] <= pos < t_hi[p] and 0 <= pos < len(panel):
                tw[p, j] = panel[pos]
    return reads2, panel, pieces, qw, tw


@pytest.mark.parametrize("band, M", [(256, 512), (512, 512)])
def test_band_dp_stats_flat_equals_the_plain_version_on_its_windows(band, M):
    reads2, panel, pieces, q, t = _flat_case(31 + band, M, band)
    launches = a1.launches
    got = a1.band_dp_stats_flat(torch.from_numpy(reads2),
                                torch.from_numpy(panel),
                                torch.from_numpy(pieces), M, band)
    assert a1.launches == launches
    ref = a1.band_dp_stats_ref(torch.from_numpy(q), torch.from_numpy(t),
                               band)
    _assert_equal(got, ref)
    assert (ref["score"] > 0).sum() > len(q) // 2


def test_band_dp_stats_flat_refuses():
    ok = np.zeros(3, np.int64)
    with pytest.raises(ValueError, match="int32"):
        a1.pack_pieces(ok, ok, ok, ok, np.array([0, 2**31, 0]))
    with pytest.raises(ValueError, match="int32"):
        a1.pack_pieces(np.array([0, -2**31 - 1, 0]), ok, ok, ok, ok)
    buf = torch.zeros(64, dtype=torch.int8)
    pieces = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        a1.band_dp_stats_flat(buf, buf, pieces[:4], 512, 256)
    with pytest.raises(TypeError):
        a1.band_dp_stats_flat(buf, buf, pieces.to(torch.int64), 512, 256)
    with pytest.raises(ValueError, match="65536"):
        a1.band_dp_stats_flat(buf, buf, pieces, 1 << 16, 256)
    with pytest.raises(ValueError, match="contiguous"):
        a1.band_dp_stats_flat(buf, buf,
                              torch.zeros((3, 5), dtype=torch.int32).T, 512,
                              256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("band, M", [(256, 512), (256, 2048), (512, 2048)])
@pytest.mark.parametrize("scores", [{}, dict(gap_open=2, gap_extend=-2),
                                    dict(mismatch=-200)],
                         ids=["defaults", "oe=0", "wide"])
def test_cuda_kernel_matches_plain_version(cuda_device, band, M, scores):
    q, t = _pieces(91, 96, M, band)
    q2, t2 = _two_local_alignments(M, band)
    q, t = np.concatenate([q, q2]), np.concatenate([t, t2])
    qd, td = (torch.from_numpy(x).to(cuda_device) for x in (q, t))
    params = DPParams(**scores)
    launches = a1.launches
    got = band_dp_stats_batch(qd, td, band, params)
    ref = a1.band_dp_stats_ref(qd, td, band, params)
    torch.cuda.synchronize()
    assert a1.launches == launches + 1
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("band, M", [(256, 512), (256, 2048), (512, 2048)])
@pytest.mark.parametrize("scores", [{}, dict(gap_open=2, gap_extend=-2),
                                    dict(mismatch=-200)],
                         ids=["defaults", "oe=0", "wide"])
def test_cuda_flat_kernel_matches_plain_version(cuda_device, band, M,
                                                scores):
    """The fused-fetch entry against the plain version on windows cut by
    hand from the same buffers."""
    reads2, panel, pieces, q, t = _flat_case(93, M, band)
    params = DPParams(**scores)
    launches = a1.launches
    got = a1.band_dp_stats_flat(
        *(torch.from_numpy(x).to(cuda_device) for x in (reads2, panel,
                                                        pieces)),
        M, band, params)
    ref = a1.band_dp_stats_ref(torch.from_numpy(q).to(cuda_device),
                               torch.from_numpy(t).to(cuda_device), band,
                               params)
    torch.cuda.synchronize()
    assert a1.launches == launches + 1
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)
