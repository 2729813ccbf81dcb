"""The port's one-pass DPs (plain versions on the CPU) vs the JAX package.

Two contracts, each held exactly against its JAX counterpart:

- ``align/extend.py:band_dp_batch`` (the ``gather`` engine): per row the
  lowest band offset among the row's maxima, the first row reaching the
  best, vs ``svjedi_tpu.align.extend.band_dp_batch``;
- ``kernels/band_dp.py`` (the pre-gathered one-pass kernel): per band cell
  the first row reaching its best, the lowest offset among the cells at
  the maximum, vs ``band_dp_pallas`` in interpret mode.

The CUDA kernel is compared with its plain version on the card by
chip_smoke.py and by the gpu-marked test at the end.
"""

import numpy as np
import pytest
import torch

from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import band_dp_batch as jax_band_dp_batch
from svjedi_tpu.kernels.band_dp import band_dp_pallas
from svjedi_tpu_torch.align.extend import DPParams, band_dp_batch
from svjedi_tpu_torch.kernels import band_dp as k4

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

KEYS = ("score", "qs", "ts", "qe", "te")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda:0")


def _problems(seed: int, P: int, M: int, band: int):
    """Noisy copies (substitutions and indels) at random band offsets, with
    interior N bases, m < M, and the edge and tie-heavy cases first: an
    all-N read, an all-N target, all mismatches (score 0), poly-A against
    poly-A, and a dinucleotide and a trinucleotide tandem repeat."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(P, M)).astype(np.int8)
    t = np.full((P, M + band), 4, dtype=np.int8)
    for p in range(P):
        copy = q[p].copy()
        flips = rng.random(M) < 0.12
        copy[flips] = rng.integers(0, 4, int(flips.sum()))
        copy = np.delete(copy, rng.integers(0, M, 3))
        copy = np.insert(copy, rng.integers(0, len(copy), 3),
                         rng.integers(0, 4, 3).astype(np.int8))
        off = int(rng.integers(0, band))
        n = min(len(copy), M + band - off)
        t[p, off : off + n] = copy[:n]
        q[p, int(rng.integers(M // 2, M + 1)):] = 4
    q[rng.random(q.shape) < 0.01] = 4
    q[0] = 4
    t[1] = 4
    q[2], t[2] = 0, 1
    q[3], t[3] = 0, 0
    q[4], t[4] = np.resize([0, 1], M), np.resize([0, 1], M + band)
    q[5], t[5] = np.resize([2, 0, 3], M), np.resize([2, 0, 3], M + band)
    return q, t


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("band, M, P", [(128, 128, 40), (128, 200, 24),
                                        (256, 160, 24)])
def test_band_dp_batch_matches_jax(band, M, P):
    q, t = _problems(band + M, P, M, band)
    ref = jax_band_dp_batch(q, t, band, JaxDPParams())
    got = band_dp_batch(*_torch(q, t), band, DPParams())
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert tuple(int(got[k][2]) for k in KEYS) == (0, 0, 0, -1, -1)


@pytest.mark.parametrize("band, M, P", [(128, 128, 16), (128, 256, 8),
                                        (256, 128, 8)])
def test_onepass_plain_matches_pallas_interpret(band, M, P):
    q, t = _problems(7 * M + band, P, M, band)
    ref = band_dp_pallas(q, t, band, JaxDPParams(), interpret=True)
    got = k4.band_dp_onepass(*_torch(q, t), band, DPParams())
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for p in range(3):  # all-N read, all-N target, all mismatches
        assert tuple(int(got[k][p]) for k in KEYS) == (0, 0, 0, -1, -1)


def test_onepass_contract_differs_from_band_dp_batch_only_on_ties():
    """Equal scores; where the tie rules pick different spans, both are
    optimal."""
    from _span_check import assert_spans_optimal

    band, M = 128, 128
    q, t = _problems(23, 32, M, band)
    one = k4.band_dp_onepass_ref(*_torch(q, t), band)
    batch = band_dp_batch(*_torch(q, t), band)
    one = {k: v.numpy() for k, v in one.items()}
    np.testing.assert_array_equal(one["score"], batch["score"].numpy())
    same = np.ones(len(q), dtype=bool)
    for key in KEYS[1:]:
        same &= one[key] == batch[key].numpy()
    assert_spans_optimal(q, t, band, JaxDPParams(), one, np.flatnonzero(~same))


def test_wrapper_rejects_bad_inputs():
    q = torch.full((8, 128), 4, dtype=torch.int8)
    t = torch.full((8, 256), 4, dtype=torch.int8)
    with pytest.raises(ValueError):
        k4.band_dp_onepass(q, t[:, :200], 128)
    with pytest.raises(TypeError):
        k4.band_dp_onepass(q.int(), t.int(), 128)
    with pytest.raises(ValueError, match="packed starts"):
        k4.band_dp_onepass(torch.full((1, 1 << 15), 4, dtype=torch.int8),
                           torch.full((1, (1 << 15) + 128), 4,
                                      dtype=torch.int8), 128)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.band_dp_onepass(q.to("meta"), t.to("meta"), 128)
    with pytest.raises(ValueError, match="band 128 or 256"):
        k4.check_kernel_band(192)
    with pytest.raises(ValueError, match="multiple of 8"):
        k4.check_kernel_rows(100)
    launches = k4.launches
    k4.band_dp_onepass(q, t, 128)
    assert k4.launches == launches  # the plain version launches nothing


#: Scores on both sides of the row-skip condition: the defaults, a zero
#: mismatch, a zero gap open, a zero extend (open + extend -4 and -1), then
#: open + extend 0 (two ways), a positive mismatch and a positive extend.
ROW_SKIP_SCORES = {
    "defaults": {}, "mismatch=0": dict(mismatch=0),
    "gap_open=0": dict(gap_open=0), "gap_extend=0": dict(gap_extend=0),
    "oe=-1": dict(gap_open=-1, gap_extend=0),
    "oe=0": dict(gap_open=2, gap_extend=-2),
    "gap_open=gap_extend=0": dict(gap_open=0, gap_extend=0),
    "mismatch=1": dict(mismatch=1), "gap_extend=1": dict(gap_extend=1),
}


@pytest.mark.parametrize("scores", ROW_SKIP_SCORES.values(),
                         ids=ROW_SKIP_SCORES.keys())
def test_trailing_sentinel_rows_change_nothing_where_rows_skip_exact(scores):
    """The premise of the kernels' row skip, on the plain version: each
    problem run up to its last non-sentinel read row, rounded up to 8,
    equals all M rows wherever rows_skip_exact holds; elsewhere some
    problem differs."""
    params = DPParams(**scores)
    band, M, P = 128, 128, 16
    q, t = _problems(61, P, M, band)
    ends = np.random.default_rng(62).integers(M // 4, M // 2 + 1, P)
    q[np.arange(M)[None, :] >= ends[:, None]] = 4
    coded = q[:, ::-1] != 4
    rows = np.where(coded.any(axis=1), M - coded.argmax(axis=1), 0)
    rows = (rows + 7) // 8 * 8
    qt, tt = _torch(q, t)
    full = k4.onepass_plain(qt, tt, band, params)
    cut = torch.tensor([[0, 0, 0, -1, -1]], dtype=torch.int32).repeat(P, 1)
    for r in np.unique(rows[rows > 0]):
        sel = torch.from_numpy(rows == r)
        cut[sel] = k4.onepass_plain(qt[sel, :r], tt[sel, :r + band], band,
                                    params)
    same = (cut == full).all(dim=1)
    if k4.rows_skip_exact(params):
        assert same.all()
    else:
        assert not same.all()


def test_onepass_with_zero_gap_open_matches_pallas_interpret():
    """open + extend = 0, where trailing sentinel rows move the result: the
    port runs every row, as the JAX kernel does."""
    band, M, P = 128, 128, 8
    q, t = _problems(67, P, M, band)
    q[:, M // 2:] = 4
    ref = band_dp_pallas(q, t, band, JaxDPParams(gap_open=2, gap_extend=-2),
                         interpret=True)
    got = k4.band_dp_onepass(*_torch(q, t), band,
                             DPParams(gap_open=2, gap_extend=-2))
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
def test_cuda_kernel_matches_plain_version(cuda_device, band):
    q, t = _problems(31, 64, 384, band)
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    launches = k4.launches
    got = k4.band_dp_onepass(qd, td, band)
    ref = k4.band_dp_onepass_ref(qd, td, band)
    torch.cuda.synchronize()
    assert k4.launches == launches + 1
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("scores", [dict(gap_open=2, gap_extend=-2),
                                    dict(mismatch=-200)],
                         ids=["oe=0", "wide"])
def test_cuda_kernel_matches_plain_version_with_other_scores(cuda_device,
                                                             band, scores):
    """A zero gap open (every row runs) and the wide build (mismatch -200),
    with an all-sentinel read beside a full one in each warp."""
    q, t = _problems(37, 64, 384, band)
    q[0::2] = 4
    q[1::2] = np.where(q[1::2] == 4, 0, q[1::2])
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    params = DPParams(**scores)
    got = k4.band_dp_onepass(qd, td, band, params)
    ref = k4.band_dp_onepass_ref(qd, td, band, params)
    torch.cuda.synchronize()
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
def test_cuda_kernel_with_positive_mismatch_matches_plain_version(cuda_device,
                                                                  band):
    """mismatch 100 at M = 1024: scores pass 2^16 at a small match, so the
    launcher must bound them by every step, not by match x M."""
    q, t = _problems(41, 64, 1024, band)
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    params = DPParams(mismatch=100)
    got = k4.band_dp_onepass(qd, td, band, params)
    ref = k4.band_dp_onepass_ref(qd, td, band, params)
    torch.cuda.synchronize()
    assert int(ref["score"].max()) >= 1 << 16
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("layout", ["M=392", "offset"])
def test_cuda_kernel_byte_row_scan_matches_plain_version(cuda_device, band,
                                                         layout):
    """The row scan's byte path: rows not a multiple of 16 bytes, or q at
    an 8-byte storage offset, with an all-sentinel read beside a full one."""
    M = 392 if layout == "M=392" else 384
    q, t = _problems(43, 64, M, band)
    q[0::2] = 4
    qd, td = (x.to(cuda_device) for x in _torch(q, t))
    if layout == "offset":
        buf = torch.empty(qd.numel() + 8, dtype=torch.int8, device=cuda_device)
        qd = buf[8:].view(qd.shape)
        qd.copy_(torch.from_numpy(q))
    got = k4.band_dp_onepass(qd, td, band)
    ref = k4.band_dp_onepass_ref(qd, td, band)
    torch.cuda.synchronize()
    for key in KEYS:
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      ref[key].cpu().numpy(), err_msg=key)
