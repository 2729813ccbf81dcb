"""The PyTorch v3 banded DP (plain version on the CPU) vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as tests/test_band_dp_v3.py runs it.
Every comparison is exact: both are the same integer DP with the same tie
rule. The CUDA kernel itself is compared with this plain version on the
card by chip_smoke.py and by the gpu-marked test at the end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import band_dp_batch
from svjedi_tpu.kernels import band_dp_v3 as jax_v3
from svjedi_tpu_torch.align.extend import DPParams
from svjedi_tpu_torch.kernels import band_dp_v3 as v3

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

BAND = 128
P = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda:0")


def _problems(seed: int, bucket: int, P: int = P, band: int = BAND,
              m_fix=None):
    """Read windows and noisy copies placed at random band offsets, plus
    edge cases: an all-sentinel read, an all-sentinel target, interior N
    bases and a problem that cannot score. ``m_fix`` sets chosen problems'
    read lengths."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(P, bucket)).astype(np.int8)
    m = rng.integers(bucket // 4, bucket + 1, size=P)
    for p, mp in (m_fix or {}).items():
        m[p] = mp
    t = np.full((P, bucket + band), 4, dtype=np.int8)
    for p in range(P):
        off = int(rng.integers(0, band))
        copy = q[p].copy()
        flips = rng.random(bucket) < 0.1
        copy[flips] = rng.integers(0, 4, size=int(flips.sum()))
        t[p, off : off + bucket] = copy
        q[p, m[p]:] = 4
    q[rng.random(q.shape) < 0.01] = 4  # interior N bases
    q[0] = 4  # m = 0
    t[1] = 4  # nothing to align against
    q[2, :] = 0
    t[2, :] = 1  # all mismatches: score 0, qe = te = -1
    return q, t


def _jax_fwd(qT, tT, bucket, n_valid=None):
    out = jax_v3.band_dp_v3_fwd(
        jnp.asarray(qT), jnp.asarray(tT), bucket, BAND, JaxDPParams(),
        n_valid=None if n_valid is None else jnp.asarray(n_valid),
        interpret=True,
    )
    return np.asarray(out)


@pytest.mark.parametrize("bucket", [128, 512])
def test_fwd_matches_jax(bucket):
    q, t = _problems(bucket, bucket)
    qT, tT = q.T.copy(), t.T.copy()
    ref = _jax_fwd(qT, tT, bucket)
    got = v3.band_dp_v3_fwd(
        torch.from_numpy(qT), torch.from_numpy(tT), bucket, BAND, DPParams()
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tuple(got[0]) == (0, -1, -1)
    assert tuple(got[1]) == (0, -1, -1)
    assert tuple(got[2]) == (0, -1, -1)


@pytest.mark.parametrize(
    "scores", [dict(match=3), dict(mismatch=-200), dict(match=200)],
    ids=["match3", "mismatch-200", "match200"],
)
def test_fwd_other_scores_match_jax(scores):
    """Scores the CUDA kernel's wide build serves (beyond int8, or match x
    bucket >= 2^16 at the large buckets) keep the JAX contract."""
    bucket = 128
    q, t = _problems(23, bucket)
    qT, tT = q.T.copy(), t.T.copy()
    ref = np.asarray(jax_v3.band_dp_v3_fwd(
        jnp.asarray(qT), jnp.asarray(tT), bucket, BAND, JaxDPParams(**scores),
        interpret=True,
    ))
    got = v3.band_dp_v3_fwd(
        torch.from_numpy(qT), torch.from_numpy(tT), bucket, BAND,
        DPParams(**scores),
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[3:, 0] > 0).any()


def test_fwd_n_valid_and_row_bounds_match_jax():
    """n_valid < P and real per-group row bounds, vs JAX and vs unbounded."""
    bucket = 256
    q, t = _problems(7, bucket)
    m = np.sort(np.random.default_rng(3).integers(32, bucket + 1, P))
    q = np.where(np.arange(bucket)[None, :] < m[:, None], q, 4).astype(np.int8)
    qT, tT = q.T.copy(), t.T.copy()
    n_valid = 200
    bounds = m.reshape(-1, 128).max(axis=1)
    nvb = np.concatenate([[n_valid], bounds]).astype(np.int32)
    ref = _jax_fwd(qT, tT, bucket, nvb)
    args = (torch.from_numpy(qT), torch.from_numpy(tT), bucket, BAND, DPParams())
    bounded = v3.band_dp_v3_fwd(*args, n_valid=torch.from_numpy(nvb)).numpy()
    unbounded = v3.band_dp_v3_fwd(*args).numpy()
    np.testing.assert_array_equal(bounded[:n_valid], ref[:n_valid])
    np.testing.assert_array_equal(bounded[:n_valid], unbounded[:n_valid])
    assert (bounded[n_valid:] == np.array([0, -1, -1])).all()


def test_two_pass_matches_jax():
    bucket = 256
    q, t = _problems(11, bucket)
    qT, tT = q.T.copy(), t.T.copy()
    ref = jax_v3.band_dp_v3(qT, tT, bucket, BAND, JaxDPParams(), interpret=True)
    got = v3.band_dp_v3(
        torch.from_numpy(qT), torch.from_numpy(tT), bucket, BAND, DPParams()
    )
    for key in ("score", "qs", "ts", "qe", "te", "score_rev"):
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(ref[key]), err_msg=key
        )


def test_rev_matches_jax():
    """The reverse pass alone on end-clamped windows, with n_valid < P."""
    bucket = 128
    q, t = _problems(13, bucket)
    qT, tT = q.T.copy(), t.T.copy()
    fwd = _jax_fwd(qT, tT, bucket)
    rows = np.arange(bucket)[:, None]
    qT2 = np.where(rows <= fwd[None, :, 1], qT, 4).astype(np.int8)
    trows = np.arange(bucket + BAND)[:, None]
    tT2 = np.where(trows <= fwd[None, :, 2], tT, 4).astype(np.int8)
    ref = np.asarray(jax_v3.band_dp_v3_rev(
        jnp.asarray(qT2), jnp.asarray(tT2), bucket, BAND, JaxDPParams(),
        n_valid=150, interpret=True,
    ))
    got = v3.band_dp_v3_rev(
        torch.from_numpy(qT2), torch.from_numpy(tT2), bucket, BAND,
        DPParams(), n_valid=150,
    ).numpy()
    np.testing.assert_array_equal(got[:150], ref[:150])
    np.testing.assert_array_equal(got[:150, 0], fwd[:150, 0])


REV_P = 128
REV_N_VALID = 100


def _rev_windows(seed: int, bucket: int):
    """End-clamped windows as the pipeline's reverse pass gets them, and the
    forward pass's qe + 1. Problem 4 is a 40-base read beside problem 5, a
    full-bucket one, so neighbouring m' differ by more than 1000 at the
    buckets used here; problems 0-2 are the edge cases of _problems."""
    q, t = _problems(seed, bucket, P=REV_P, m_fix={4: 40, 5: bucket})
    qT, tT = q.T.copy(), t.T.copy()
    fwd = _jax_fwd(qT, tT, bucket)
    rows = np.arange(bucket)[:, None]
    qT2 = np.where(rows <= fwd[None, :, 1], qT, 4).astype(np.int8)
    trows = np.arange(bucket + BAND)[:, None]
    tT2 = np.where(trows <= fwd[None, :, 2], tT, 4).astype(np.int8)
    return qT2, tT2, (fwd[:, 1] + 1).astype(np.int32)


def _rev_by_addressing(qT2, tT2, m, bucket, n_valid, params=DPParams()):
    """The reverse kernel's addressing in numpy: reversed row r reads row
    m - 1 - r and reversed cell k target row m - 1 - r + BAND - 1 - k (both
    sentinel below 0); the plain forward pass on those windows, mapped back
    to qs = m - 1 - r*, ts = qs + BAND - 1 - k*."""
    cols = np.arange(qT2.shape[1])[None, :]
    qi = m[None, :] - 1 - np.arange(bucket)[:, None]
    qR = np.where(qi >= 0, qT2[qi.clip(0), cols], 4).astype(np.int8)
    ti = m[None, :] + BAND - 2 - np.arange(bucket + BAND)[:, None]
    tR = np.where(ti >= 0, tT2[ti.clip(0), cols], 4).astype(np.int8)
    out = v3.band_dp_v3_fwd_ref(torch.from_numpy(qR), torch.from_numpy(tR),
                                bucket, BAND, params, n_valid).numpy()
    scored = out[:, 1] >= 0
    qs = m - 1 - out[:, 1]
    ts = qs + BAND - 1 - (out[:, 2] - out[:, 1])
    return np.stack([out[:, 0], np.where(scored, qs, bucket),
                     np.where(scored, ts, bucket + BAND - 1)], axis=1)


@pytest.mark.parametrize("bucket", [1152, 2048])
def test_rev_with_m_matches_jax(bucket):
    """band_dp_v3_rev with an explicit m = qe + 1 and with the derived m
    equals the JAX reverse pass, n_valid < P; the reverse kernel's backward
    addressing (numpy model) gives the same rows."""
    qT2, tT2, m = _rev_windows(bucket + 1, bucket)
    assert m[5] - m[4] > 1000
    ref = np.asarray(jax_v3.band_dp_v3_rev(
        jnp.asarray(qT2), jnp.asarray(tT2), bucket, BAND, JaxDPParams(),
        n_valid=REV_N_VALID, interpret=True,
    ))
    np.testing.assert_array_equal(v3.valid_rows(torch.from_numpy(qT2)).numpy(), m)
    args = (torch.from_numpy(qT2), torch.from_numpy(tT2), bucket, BAND,
            DPParams(), REV_N_VALID)
    none = (0, bucket, bucket + BAND - 1)
    for m_arg in (torch.from_numpy(m), None):
        got = v3.band_dp_v3_rev(*args, m=m_arg).numpy()
        np.testing.assert_array_equal(got[:REV_N_VALID], ref[:REV_N_VALID])
        assert (got[REV_N_VALID:] == np.array(none)).all()
        for p in (0, 1, 2):  # all-sentinel read or target, all mismatches
            assert tuple(got[p]) == none
    model = _rev_by_addressing(qT2, tT2, m, bucket, REV_N_VALID)
    np.testing.assert_array_equal(model, got)


#: Scores where a sentinel row can change H (a positive mismatch, open +
#: extend or extend): the reverse kernel then runs every row, m = bucket.
POSITIVE_SCORES = {"mismatch1": dict(mismatch=1),
                   "open_extend1": dict(gap_open=3, gap_extend=-2),
                   "extend1": dict(gap_extend=1)}


@pytest.mark.parametrize("scores", POSITIVE_SCORES.values(),
                         ids=POSITIVE_SCORES.keys())
def test_rev_positive_scores_every_row_matches_jax(scores):
    """At such scores the reverse kernel's backward addressing with m =
    bucket for every problem (numpy model) equals the JAX reverse pass, and
    so does the port's reverse pass on the CPU."""
    bucket = 256
    params = DPParams(**scores)
    qT2, tT2, _ = _rev_windows(41, bucket)
    ref = np.asarray(jax_v3.band_dp_v3_rev(
        jnp.asarray(qT2), jnp.asarray(tT2), bucket, BAND,
        JaxDPParams(**scores), n_valid=REV_N_VALID, interpret=True,
    ))
    full = np.full(REV_P, bucket, dtype=np.int32)
    model = _rev_by_addressing(qT2, tT2, full, bucket, REV_N_VALID, params)
    np.testing.assert_array_equal(model[:REV_N_VALID], ref[:REV_N_VALID])
    got = v3.band_dp_v3_rev(torch.from_numpy(qT2), torch.from_numpy(tT2),
                            bucket, BAND, params, REV_N_VALID).numpy()
    np.testing.assert_array_equal(got[:REV_N_VALID], ref[:REV_N_VALID])
    assert (ref[:REV_N_VALID, 0] > 0).any()


def test_two_pass_against_one_pass_reference():
    """Scores equal band_dp_batch; a differing span must still be optimal."""
    from _span_check import assert_spans_optimal

    bucket = 128
    q, t = _problems(17, bucket, P=128)
    ref = band_dp_batch(q, t, BAND, JaxDPParams())
    got = v3.band_dp_v3(
        torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy()), bucket,
        BAND, DPParams(),
    )
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["score"], np.asarray(ref["score"]))
    np.testing.assert_array_equal(got["score_rev"], got["score"])
    same = np.ones(len(q), dtype=bool)
    for key in ("qs", "ts", "qe", "te"):
        same &= got[key] == np.asarray(ref[key])
    assert_spans_optimal(q, t, BAND, JaxDPParams(), got, np.flatnonzero(~same))


def test_wrapper_rejects_bad_inputs():
    q = torch.full((128, 128), 4, dtype=torch.int8)
    t = torch.full((256, 128), 4, dtype=torch.int8)
    with pytest.raises(ValueError):
        v3.band_dp_v3_fwd(q[:, :100], t[:, :100], 128, BAND)
    with pytest.raises(TypeError):
        v3.band_dp_v3_fwd(q.int(), t.int(), 128, BAND)
    with pytest.raises(ValueError):
        v3.band_dp_v3_fwd(q, t[:200], 128, BAND)
    launches = v3.launches
    v3.band_dp_v3_fwd(q, t, 128, BAND)
    assert v3.launches == launches  # the plain version launches nothing


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(cuda_device):
    bucket = 512
    q, t = _problems(19, bucket)
    qT = torch.from_numpy(q.T.copy()).to(cuda_device)
    tT = torch.from_numpy(t.T.copy()).to(cuda_device)
    nvb = torch.tensor([200, 512, 300], dtype=torch.int32, device=cuda_device)
    launches = v3.launches
    got = v3.band_dp_v3_fwd(qT, tT, bucket, BAND, DPParams(), n_valid=nvb)
    ref = v3.band_dp_v3_fwd_ref(qT, tT, bucket, BAND, DPParams(), n_valid=nvb)
    torch.cuda.synchronize()
    assert v3.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("scores", [dict(mismatch=-200), dict(match=200)],
                         ids=["mismatch-200", "match200"])
def test_cuda_kernel_wide_build_matches_plain_version(cuda_device, scores):
    """Scores outside int8 take the kernel's wide build."""
    bucket = 512
    q, t = _problems(29, bucket)
    qT = torch.from_numpy(q.T.copy()).to(cuda_device)
    tT = torch.from_numpy(t.T.copy()).to(cuda_device)
    params = DPParams(**scores)
    got = v3.band_dp_v3_fwd(qT, tT, bucket, BAND, params)
    ref = v3.band_dp_v3_fwd_ref(qT, tT, bucket, BAND, params)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "band, scores", [(128, {}), (128, dict(mismatch=-200)), (256, {}),
                     (256, dict(match=200))],
    ids=["narrow", "wide", "band256", "band256-wide"],
)
def test_cuda_rev_kernel_matches_plain_version(cuda_device, band, scores):
    """The reverse kernel (explicit and derived m) against the flipped
    forward pass, narrow and wide builds, at both bands."""
    bucket = 1152
    q, t = _problems(31, bucket, P=REV_P, band=band, m_fix={4: 40, 5: bucket})
    params = DPParams(**scores)
    qT = torch.from_numpy(q.T.copy()).to(cuda_device)
    tT = torch.from_numpy(t.T.copy()).to(cuda_device)
    fwd = v3.band_dp_v3_fwd_ref(qT, tT, bucket, band, params)
    qe, te = fwd[:, 1], fwd[:, 2]
    rows = torch.arange(bucket, device=cuda_device)[:, None]
    qT2 = torch.where(rows <= qe[None], qT, 4).to(torch.int8)
    trows = torch.arange(bucket + band, device=cuda_device)[:, None]
    tT2 = torch.where(trows <= te[None], tT, 4).to(torch.int8)
    ref = v3.band_dp_v3_rev_ref(qT2, tT2, bucket, band, params, REV_N_VALID)
    launches, rev = v3.launches, v3.rev_launches
    for m in (qe + 1, None):
        got = v3.band_dp_v3_rev(qT2, tT2, bucket, band, params, REV_N_VALID,
                                m=m)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    assert v3.rev_launches == rev + 2 and v3.launches == launches + 2


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("scores", POSITIVE_SCORES.values(),
                         ids=POSITIVE_SCORES.keys())
def test_cuda_rev_kernel_positive_scores_match_plain_version(cuda_device,
                                                             scores, band):
    """The reverse kernel takes every score the JAX reverse pass takes: at a
    positive mismatch or gap score it runs every row, whatever m it is
    given, and equals the flipped forward pass."""
    bucket = 1152
    q, t = _problems(43, bucket, P=REV_P, band=band, m_fix={4: 40, 5: bucket})
    params = DPParams(**scores)
    qT = torch.from_numpy(q.T.copy()).to(cuda_device)
    tT = torch.from_numpy(t.T.copy()).to(cuda_device)
    fwd = v3.band_dp_v3_fwd_ref(qT, tT, bucket, band, params)
    qe, te = fwd[:, 1], fwd[:, 2]
    rows = torch.arange(bucket, device=cuda_device)[:, None]
    qT2 = torch.where(rows <= qe[None], qT, 4).to(torch.int8)
    trows = torch.arange(bucket + band, device=cuda_device)[:, None]
    tT2 = torch.where(trows <= te[None], tT, 4).to(torch.int8)
    ref = v3.band_dp_v3_rev_ref(qT2, tT2, bucket, band, params, REV_N_VALID)
    for m in (qe + 1, None):
        got = v3.band_dp_v3_rev(qT2, tT2, bucket, band, params, REV_N_VALID,
                                m=m)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
