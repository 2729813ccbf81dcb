"""The port's fused-fetch one-pass DP (plain version on the CPU) vs JAX.

Each package uploads the same read codes and panel with its own ``upload``
(byte-equal buffers); the same five (P,) window vectors then go through
``band_dp_dma`` (JAX, interpret mode) and its counterpart in
``svjedi_tpu_torch/kernels/band_dp_dma.py``. Every comparison is exact. The
CUDA kernel is compared with its plain version on the card by
chip_smoke.py and by the gpu-marked test at the end.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svjedi_tpu.align import device as jdev
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.kernels.band_dp_dma import band_dp_dma as jax_band_dp_dma
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.kernels import band_dp as k4
from svjedi_tpu_torch.kernels import band_dp_dma as k3

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = ("score", "qs", "ts", "qe", "te")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda:0")


def layout(seed: int, P: int, bucket: int, band: int, device=CPU):
    """Reads that are noisy copies of stretches of two panel paths, every
    odd one reverse-complemented, uploaded by both packages. Problems alternate
    forward windows and reverse-strand windows (in the rc half of reads2);
    target windows start up to half a bucket before their path and may run
    past its end; m < bucket, and the last two problems are padding rows
    with m = 0. Returns (jax DeviceData, port DeviceData, five int32
    vectors in band_dp_dma's order: q_start, t_start, m, t_lo, t_hi)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, n).astype(np.int8) for n in (3 * bucket, 5 * bucket)]
    panel = SimpleNamespace(paths=[SimpleNamespace(seq=s, length=len(s)) for s in seqs])
    pi = rng.integers(0, 2, P)
    pos = np.array([rng.integers(-bucket // 2, len(seqs[i]) - bucket // 2) for i in pi])
    pos[0], pos[1] = -bucket // 2, len(seqs[pi[1]]) - bucket // 2  # path edges
    reads = []
    for p in range(P):
        s = seqs[pi[p]]
        idx = pos[p] + np.arange(bucket)
        r = np.where((idx >= 0) & (idx < len(s)), s[idx.clip(0, len(s) - 1)],
                     rng.integers(0, 4, bucket)).astype(np.int8)
        flips = rng.random(bucket) < 0.1
        r[flips] = rng.integers(0, 4, int(flips.sum()))
        r[rng.random(bucket) < 0.01] = 4
        if p % 2:
            r = np.where(r < 4, 3 - r, r)[::-1].astype(np.int8)
        reads.append(r)
    codes = np.concatenate(reads)
    jd = jdev.upload(codes, panel, max_window=2 * bucket)
    td = tdev.upload(codes, panel, device, max_window=2 * bucket)
    N = jd.n_bases
    off = np.arange(P) * bucket
    q_start = np.where(np.arange(P) % 2, 2 * N - (off + bucket), off)
    m = rng.integers(bucket // 4, bucket + 1, P)
    m[-2:] = 0
    t_lo = jd.panel_start[pi]
    t_hi = t_lo + jd.panel_len[pi]
    t_start = t_lo + pos - band // 2 + rng.integers(-8, 9, P)
    vecs = tuple(v.astype(np.int32) for v in (q_start, t_start, m, t_lo, t_hi))
    return jd, td, vecs


def _port(td, vecs, bucket, band, fn=k3.band_dp_dma):
    T = (torch.from_numpy(v).to(td.reads2.device) for v in vecs)
    return fn(td.reads2, td.panel_padded, *T, bucket=bucket, band=band)


@pytest.mark.parametrize("bucket, band, P", [(128, 128, 16), (256, 128, 8),
                                             (128, 256, 8)])
def test_plain_matches_jax_interpret(bucket, band, P):
    jd, td, vecs = layout(bucket + band, P, bucket, band)
    q_start, t_start, _, t_lo, t_hi = vecs
    assert (q_start >= jd.n_bases).any()  # reverse-strand windows
    assert (t_start < t_lo).any() and (t_start + bucket + band > t_hi).any()
    np.testing.assert_array_equal(td.reads2.numpy(), np.asarray(jd.reads2))
    np.testing.assert_array_equal(td.panel_padded.numpy(),
                                  np.asarray(jd.panel_padded))
    ref = jax_band_dp_dma(jd.reads2, jd.panel_padded, *vecs, bucket=bucket,
                          band=band, params=JaxDPParams(), interpret=True)
    got = _port(td, vecs, bucket, band)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert (got["score"][:-2] > 0).all()
    for p in (P - 2, P - 1):  # padding rows score 0
        assert tuple(int(got[k][p]) for k in KEYS) == (0, 0, 0, -1, -1)


def _short_beside_full(vecs, bucket):
    """m = 0 and m = bucket alternating: neighbours share a warp in the
    kernel (two problems per warp at band 128)."""
    q_start, t_start, m, t_lo, t_hi = vecs
    m = np.where(np.arange(len(m)) % 2 == 0, 0, bucket).astype(np.int32)
    return q_start, t_start, m, t_lo, t_hi


@pytest.mark.parametrize("bucket, band", [(128, 128), (128, 256)])
def test_plain_matches_jax_short_beside_full(bucket, band):
    """Problems with m = 0 beside problems with m = bucket."""
    P = 8
    jd, td, vecs = layout(bucket + 2 * band, P, bucket, band)
    vecs = _short_beside_full(vecs, bucket)
    ref = jax_band_dp_dma(jd.reads2, jd.panel_padded, *vecs, bucket=bucket,
                          band=band, params=JaxDPParams(), interpret=True)
    got = _port(td, vecs, bucket, band)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for p in range(0, P, 2):
        assert tuple(int(got[k][p]) for k in KEYS) == (0, 0, 0, -1, -1)
    assert (got["score"][1::2] > 0).all()


def test_plain_matches_jax_with_zero_gap_open():
    """open + extend = 0, where rows past m move the result: the port runs
    every bucket row, as the JAX kernel does."""
    from svjedi_tpu_torch.align.extend import DPParams

    bucket, band, P = 128, 128, 8
    jd, td, vecs = layout(71, P, bucket, band)
    ref = jax_band_dp_dma(jd.reads2, jd.panel_padded, *vecs, bucket=bucket,
                          band=band, params=JaxDPParams(gap_open=2,
                                                        gap_extend=-2),
                          interpret=True)
    T = (torch.from_numpy(v) for v in vecs)
    got = k3.band_dp_dma(td.reads2, td.panel_padded, *T, bucket=bucket,
                         band=band, params=DPParams(gap_open=2, gap_extend=-2))
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


def test_raw_is_onepass_on_gathered_windows():
    """(P, 8) raw layout, and the fused fetch equals the byte gather plus
    the pre-gathered DP on all five columns."""
    bucket, band, P = 256, 128, 24
    _, td, vecs = layout(3, P, bucket, band)
    raw = _port(td, vecs, bucket, band, fn=k3.band_dp_dma_raw)
    assert raw.shape == (P, 8) and raw.dtype == torch.int32
    assert not raw[:, 5:].any()
    T = [torch.from_numpy(v) for v in vecs]
    q_start, t_start, m, t_lo, t_hi = T
    q, t = tdev.gather_windows(td.reads2, td.panel_padded, q_start, m, t_start,
                             t_lo, t_hi, bucket, band)
    one = k4.band_dp_onepass(q, t, band)
    for c, key in enumerate(KEYS):
        np.testing.assert_array_equal(raw[:, c].numpy(), one[key].numpy())


def test_wrapper_rejects_bad_inputs():
    _, td, vecs = layout(5, 8, 128, 128)
    T = [torch.from_numpy(v) for v in vecs]
    buf = (td.reads2, td.panel_padded)
    with pytest.raises(ValueError, match="packed starts"):
        k3.band_dp_dma_raw(*buf, *T, bucket=1 << 15, band=128)
    with pytest.raises(TypeError):
        k3.band_dp_dma_raw(*buf, *[v.long() for v in T], bucket=128, band=128)
    with pytest.raises(TypeError):
        k3.band_dp_dma_raw(td.reads2.int(), td.panel_padded, *T, bucket=128,
                           band=128)
    with pytest.raises(ValueError, match="unsupported device"):
        k3.band_dp_dma_raw(*(b.to("meta") for b in buf),
                           *(v.to("meta") for v in T), bucket=128, band=128)
    launches = k3.launches
    k3.band_dp_dma_raw(*buf, *T, bucket=128, band=128)
    assert k3.launches == launches  # the plain version launches nothing


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
def test_cuda_kernel_matches_plain_version(cuda_device, band):
    bucket, P = 512, 64
    _, td, vecs = layout(41, P, bucket, band, device=cuda_device)
    launches = k3.launches
    got = _port(td, vecs, bucket, band, fn=k3.band_dp_dma_raw)
    T = [torch.from_numpy(v).to(cuda_device) for v in vecs]
    ref = k3.band_dp_dma_raw_ref(td.reads2, td.panel_padded, *T,
                                 bucket=bucket, band=band)
    torch.cuda.synchronize()
    assert k3.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("scores", [{}, dict(mismatch=-200)],
                         ids=["narrow", "wide"])
def test_cuda_kernel_short_beside_full_matches_plain_version(cuda_device,
                                                            band, scores):
    """Both builds at both bands, with m = 0 beside m = bucket in a warp."""
    from svjedi_tpu_torch.align.extend import DPParams

    bucket, P = 512, 64
    _, td, vecs = layout(43, P, bucket, band, device=cuda_device)
    T = [torch.from_numpy(v).to(cuda_device)
         for v in _short_beside_full(vecs, bucket)]
    params = DPParams(**scores)
    got = k3.band_dp_dma_raw(td.reads2, td.panel_padded, *T, bucket=bucket,
                             band=band, params=params)
    ref = k3.band_dp_dma_raw_ref(td.reads2, td.panel_padded, *T,
                                 bucket=bucket, band=band, params=params)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
def test_cuda_kernel_with_zero_gap_open_matches_plain_version(cuda_device,
                                                             band):
    """open + extend = 0: every bucket row runs, whatever m is."""
    from svjedi_tpu_torch.align.extend import DPParams

    bucket, P = 512, 64
    _, td, vecs = layout(47, P, bucket, band, device=cuda_device)
    T = [torch.from_numpy(v).to(cuda_device) for v in vecs]
    params = DPParams(gap_open=2, gap_extend=-2)
    got = k3.band_dp_dma_raw(td.reads2, td.panel_padded, *T, bucket=bucket,
                             band=band, params=params)
    ref = k3.band_dp_dma_raw_ref(td.reads2, td.panel_padded, *T,
                                 bucket=bucket, band=band, params=params)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("band", [128, 256])
def test_cuda_kernel_with_positive_mismatch_matches_plain_version(cuda_device,
                                                                  band):
    """mismatch 100 at bucket 1024: scores pass 2^16 at a small match, so
    the launcher must bound them by every step, not by match x bucket."""
    from svjedi_tpu_torch.align.extend import DPParams

    bucket, P = 1024, 64
    _, td, vecs = layout(53, P, bucket, band, device=cuda_device)
    T = [torch.from_numpy(v).to(cuda_device) for v in vecs]
    params = DPParams(mismatch=100)
    got = k3.band_dp_dma_raw(td.reads2, td.panel_padded, *T, bucket=bucket,
                             band=band, params=params)
    ref = k3.band_dp_dma_raw_ref(td.reads2, td.panel_padded, *T,
                                 bucket=bucket, band=band, params=params)
    torch.cuda.synchronize()
    assert int(ref[:, 0].max()) >= 1 << 16
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
