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


def _problems(seed: int, bucket: int, P: int = P):
    """Read windows and noisy copies placed at random band offsets, plus
    edge cases: an all-sentinel read, an all-sentinel target, interior N
    bases and a problem that cannot score."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(P, bucket)).astype(np.int8)
    m = rng.integers(bucket // 4, bucket + 1, size=P)
    t = np.full((P, bucket + BAND), 4, dtype=np.int8)
    for p in range(P):
        off = int(rng.integers(0, BAND))
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
