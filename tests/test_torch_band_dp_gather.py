"""The gather engine's one-pass DP (G1) of the port vs the JAX package.

``svjedi_tpu_torch.kernels.band_dp_gather`` (on the CPU: its plain version,
the row loop of ``align/extend.py``) must equal
``svjedi_tpu.align.extend.band_dp_batch`` (XLA on the CPU) exactly on all
five outputs: at bands 128, 256 and 512, on ragged windows, all-sentinel
rows, tandem repeats, two equal local alignments where the row rule (G1's)
and the per-cell rule (K1's, K4's) part, and at scores where
every row must run. ``band_dp_batch`` routes to it, and so do
``window_score(engine="gather")`` and the count step's ``xla`` engine;
``band_dp_batch(per_cell=True)``, K4's plain version, never does. The CUDA
kernel is held against its plain version on the card (``chip_smoke.py``
phase 2f and the gpu-marked tests at the end).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from svjedi_tpu.align import device as jdev
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import band_dp_batch as jax_band_dp_batch
from svjedi_tpu.dist import engine as jeng
from svjedi_tpu.kernels.band_dp import band_dp_pallas
from svjedi_tpu_torch import entry
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align.extend import DPParams, band_dp_batch
from svjedi_tpu_torch.dist import engine as teng
from svjedi_tpu_torch.kernels import band_dp as k4
from svjedi_tpu_torch.kernels import band_dp_gather as g1
from test_torch_band_dp import ROW_SKIP_SCORES, _problems

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

KEYS = g1.GATHER_COLS
CPU = torch.device("cpu")
#: Tie-heavy scores: the defaults, a zero gap open and a positive mismatch
#: (every row runs on the card), and the wide build's mismatch.
SCORES = {"defaults": {}, "oe=0": dict(gap_open=2, gap_extend=-2),
          "mismatch=1": dict(mismatch=1), "wide": dict(mismatch=-200)}
#: The problem that parts the end rules (see _tie_problems).
PAIR = 6


def _tie_problems(seed: int, P: int, M: int, band: int):
    """``_problems``' set (an all-N read, an all-N target, all mismatches,
    poly-A, di- and trinucleotide repeats first, ragged reads) and at
    PAIR two equal local alignments of 30 bases: the first ends at row 29
    on band offset band - 28, the second at row 69 on offset 20. The row
    rule reports the first, the per-cell rule the second."""
    q, t = _problems(seed, P, M, band)
    rng = np.random.default_rng(5)
    x, y = (rng.integers(0, 4, 30).astype(np.int8) for _ in range(2))
    q[PAIR], t[PAIR] = 4, 4
    q[PAIR, :30], t[PAIR, band - 28:band + 2] = x, x
    q[PAIR, 40:70], t[PAIR, 60:90] = y, y
    return q, t


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_equal(got, ref):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("scores", SCORES.values(), ids=SCORES.keys())
@pytest.mark.parametrize("band, M, P", [(128, 128, 32), (256, 136, 24),
                                        (512, 96, 16)])
def test_plain_route_matches_jax(band, M, P, scores):
    q, t = _tie_problems(band + M, P, M, band)
    ref = jax_band_dp_batch(q, t, band, JaxDPParams(**scores))
    got = g1.band_dp_gather(*_torch(q, t), band, DPParams(**scores))
    _assert_equal({k: v.numpy() for k, v in got.items()}, ref)
    if not scores:  # all mismatches, an all-N read, an all-N target
        for p in range(3):
            assert tuple(int(got[k][p]) for k in KEYS) == (0, 0, 0, -1, -1)


def test_end_rules_part_on_two_equal_alignments():
    """G1 (the row rule) and K4 (per cell) report different ends of equal
    score, each equal to its JAX counterpart."""
    band, M = 128, 128
    q, t = _tie_problems(3, 16, M, band)
    params = JaxDPParams()
    batch = jax_band_dp_batch(q, t, band, params)
    pallas = band_dp_pallas(q, t, band, params, interpret=True)
    ours = g1.band_dp_gather(*_torch(q, t), band)
    per_cell = k4.band_dp_onepass(*_torch(q, t), band)
    _assert_equal({k: v.numpy() for k, v in ours.items()}, batch)
    _assert_equal({k: v.numpy() for k, v in per_cell.items()}, pallas)
    assert tuple(int(ours[k][PAIR]) for k in KEYS) == \
        (60, 0, band - 28, 29, band + 1)
    assert tuple(int(per_cell[k][PAIR]) for k in KEYS) == (60, 40, 60, 69, 89)


@pytest.mark.parametrize("band, M, P", [(128, 128, 16), (256, 128, 8)])
def test_per_cell_stays_plain_and_matches_pallas_interpret(band, M, P,
                                                           monkeypatch):
    """``band_dp_batch(per_cell=True)`` is K4's plain version: it equals the
    JAX kernel and never reaches G1's wrapper."""
    def refuse(*args, **kw):
        raise AssertionError("per_cell reached band_dp_gather")

    monkeypatch.setattr(g1, "band_dp_gather", refuse)
    q, t = _tie_problems(9 * M + band, P, M, band)
    ref = band_dp_pallas(q, t, band, JaxDPParams(), interpret=True)
    got = band_dp_batch(*_torch(q, t), band, DPParams(), per_cell=True)
    _assert_equal({k: v.numpy() for k, v in got.items()}, ref)


class _Spy:
    """Counts calls of G1's wrapper and passes them on."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = g1.band_dp_gather

        def spy(*args, **kw):
            self.calls += 1
            return real(*args, **kw)

        monkeypatch.setattr(g1, "band_dp_gather", spy)


def test_band_dp_batch_routes_to_the_wrapper(monkeypatch):
    spy = _Spy(monkeypatch)
    q, t = _tie_problems(17, 8, 128, 128)
    out = band_dp_batch(*_torch(q, t), 128)
    assert spy.calls == 1
    _assert_equal({k: v.numpy() for k, v in out.items()},
                  jax_band_dp_batch(q, t, 128, JaxDPParams()))


@pytest.mark.parametrize("band", [128, 256])
def test_window_score_gather_goes_through_g1_and_matches_jax(band,
                                                            monkeypatch):
    from test_torch_band_dp_dma import layout

    spy = _Spy(monkeypatch)
    bucket, P = 128, 16
    jd, td, (q_start, t_start, m, t_lo, t_hi) = layout(13, P, bucket, band)
    meta = np.stack([q_start, m, t_start, t_lo, t_hi])
    ref = np.asarray(jdev.window_score_packed(
        jd.reads2, jd.panel_padded, jnp.asarray(meta), bucket=bucket,
        band=band, params=JaxDPParams(), engine="gather"))
    got = tdev.window_score_packed(td.reads2, td.panel_padded,
                                   torch.from_numpy(meta), bucket, band,
                                   DPParams(), "gather")
    assert spy.calls == 1
    np.testing.assert_array_equal(got.numpy(), ref)


def test_xla_count_step_goes_through_g1_and_matches_jax(monkeypatch):
    """The dry run's one-device truth: every output of the ``xla`` step on
    the 1-shard production problem, exact against JAX's."""
    spy = _Spy(monkeypatch)
    jp = graft._production_problem()
    tp = entry.production_problem(device=CPU)
    kw = dict(bucket=tp["bucket"], band=tp["band"], n_groups=tp["n_groups"],
              n_tags=tp["n_tags"], engine="xla")

    def args(p):
        return (*p["data"].packed_words(), p["meta"], p["path_start"],
                p["group"], p["cand_path"], p["owned"])

    ours = teng.dp_filter_count_v3(*args(tp), params=tp["params"], **kw)
    theirs = jeng.dp_filter_count_v3(*args(jp), params=JaxDPParams(), **kw)
    assert spy.calls == 1
    for k in ("counts", "score", "qs", "ts", "qe", "te", "is_winner"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
    assert int(ours["counts"].sum()) > 0


def test_plain_route_takes_any_band_and_row_count():
    """The plain version has none of the kernel's shape limits (band 192,
    rows not a multiple of 8), as JAX's program has none."""
    q, t = _tie_problems(29, 8, 100, 192)
    got = g1.band_dp_gather(*_torch(q, t), 192)
    _assert_equal({k: v.numpy() for k, v in got.items()},
                  jax_band_dp_batch(q, t, 192, JaxDPParams()))


def test_wrapper_rejects_bad_inputs():
    q = torch.full((8, 128), 4, dtype=torch.int8)
    t = torch.full((8, 256), 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="expected t"):
        g1.band_dp_gather(q, t[:, :200], 128)
    with pytest.raises(TypeError):
        g1.band_dp_gather(q.int(), t.int(), 128)
    with pytest.raises(ValueError, match="unsupported device"):
        g1.band_dp_gather(q.to("meta"), t.to("meta"), 128)
    with pytest.raises(ValueError, match="band 128, 256 or 512"):
        g1.check_kernel_shape(192, 128)
    with pytest.raises(ValueError, match="multiple of 16"):
        g1.check_kernel_shape(512, 120)
    with pytest.raises(ValueError, match="multiple of 8"):
        g1.check_kernel_shape(128, 100)
    with pytest.raises(ValueError, match="packed starts"):
        g1.check_kernel_shape(128, 1 << 15)
    g1.check_kernel_shape(512, 1 << 14)
    launches = g1.launches
    g1.band_dp_gather(q, t, 128)
    assert g1.launches == launches  # the plain version launches nothing


@pytest.mark.parametrize("scores", ROW_SKIP_SCORES.values(),
                         ids=ROW_SKIP_SCORES.keys())
def test_trailing_sentinel_rows_change_nothing_where_rows_skip_exact(scores):
    """The premise of G1's row skip under the row rule, on the plain
    version: each problem run up to its last non-sentinel read row,
    rounded up to 8, equals all M rows wherever rows_skip_exact holds; at a
    positive score some problem differs."""
    params = DPParams(**scores)
    band, M, P = 128, 128, 16
    q, t = _tie_problems(71, P, M, band)
    ends = np.random.default_rng(72).integers(M // 4, M // 2 + 1, P)
    q[np.arange(M)[None, :] >= ends[:, None]] = 4
    coded = q[:, ::-1] != 4
    rows = np.where(coded.any(axis=1), M - coded.argmax(axis=1), 0)
    rows = (rows + 7) // 8 * 8
    qt, tt = _torch(q, t)

    def run(qq, tt_):
        out = g1.band_dp_gather_ref(qq, tt_, band, params)
        return torch.stack([out[k] for k in KEYS], dim=1)

    full = run(qt, tt)
    cut = torch.tensor([[0, 0, 0, -1, -1]], dtype=torch.int32).repeat(P, 1)
    for r in np.unique(rows[rows > 0]):
        sel = torch.from_numpy(rows == r)
        cut[sel] = run(qt[sel, :r], tt[sel, :r + band])
    same = (cut == full).all(dim=1)
    if k4.rows_skip_exact(params):
        assert same.all()
    elif max(params.mismatch, params.gap_extend) > 0:
        assert not same.all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("scores", [{}, dict(gap_open=2, gap_extend=-2),
                                    dict(mismatch=-200), dict(mismatch=100)],
                         ids=["defaults", "oe=0", "wide", "mismatch=100"])
@pytest.mark.parametrize("band", [128, 256, 512])
def test_cuda_kernel_matches_plain_version(cuda_device, band, scores):
    """Every build, with an all-sentinel read beside a full one in each
    warp, and the two equal alignments that part the end rules."""
    q, t = _tie_problems(31, 64, 384, band)
    q[8::2] = 4
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    params = DPParams(**scores)
    launches = g1.launches
    got = g1.band_dp_gather(qd, td, band, params)
    ref = g1.band_dp_gather_ref(qd, td, band, params)
    torch.cuda.synchronize()
    assert g1.launches == launches + 1
    _assert_equal({k: v.cpu().numpy() for k, v in got.items()},
                  {k: v.cpu().numpy() for k, v in ref.items()})


@pytest.mark.gpu
def test_cuda_band_dp_batch_launches_g1_and_refuses_what_it_cannot_take(
        cuda_device):
    q, t = _tie_problems(37, 32, 128, 128)
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    launches = g1.launches
    band_dp_batch(qd, td, 128)
    band_dp_batch(qd, td, 128, per_cell=True)  # K4's plain version
    assert g1.launches == launches + 1
    with pytest.raises(ValueError, match="band 128, 256 or 512"):
        band_dp_batch(qd[:, :64], td[:, :64 + 192], 192)
    with pytest.raises(ValueError, match="contiguous"):
        band_dp_batch(qd.T.contiguous().T, td, 128)
