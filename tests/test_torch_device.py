"""The port's device layout, window prep and audit DP vs the JAX package.

Same inputs (numpy, from a seed) through ``svjedi_tpu.align.device`` /
``svjedi_tpu.align.extend`` and their ``svjedi_tpu_torch`` counterparts on
the CPU; every comparison is exact. JAX packs words as uint32, the port as
int64 holding the same 32-bit patterns.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svjedi_tpu.align import device as jdev
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import band_dp_stats_batch as jax_stats
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align.extend import DPParams, band_dp_stats_batch

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x).astype(np.int64) if np.asarray(x).dtype == np.uint32 \
        else np.asarray(x)


def _panel(rng, n_paths=5):
    paths = []
    for _ in range(n_paths):
        seq = rng.integers(0, 4, int(rng.integers(300, 2000)), dtype=np.int8)
        seq[rng.random(len(seq)) < 0.01] = 4
        paths.append(SimpleNamespace(seq=seq, length=len(seq)))
    return SimpleNamespace(paths=paths)


def _codes(rng, n):
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[rng.random(n) < 0.02] = 4
    return codes


def test_upload_matches_jax():
    rng = np.random.default_rng(0)
    panel = _panel(rng)
    codes = _codes(rng, 9000)
    jd = jdev.upload(codes, panel, max_window=2048)
    cache = {}
    td = tdev.upload(codes, panel, CPU, panel_cache=cache, max_window=2048)
    for name in ("reads2", "panel_padded"):
        np.testing.assert_array_equal(
            _np(getattr(td, name)), _np(getattr(jd, name)), err_msg=name
        )
    for i, (a, b) in enumerate(zip(td.packed_words(), jd.packed_words())):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"packed[{i}]")
    np.testing.assert_array_equal(td.panel_start, jd.panel_start)
    np.testing.assert_array_equal(td.panel_len, jd.panel_len)
    assert (td.n_bases, td.pad) == (jd.n_bases, jd.pad)
    # A second chunk reuses the cached panel buffers.
    codes2 = _codes(rng, 3000)
    td2 = tdev.upload(codes2, panel, CPU, panel_cache=cache, max_window=2048)
    jd2 = jdev.upload(codes2, panel, max_window=2048)
    assert td2.panel_padded is td.panel_padded
    np.testing.assert_array_equal(_np(td2.reads2), _np(jd2.reads2))


@pytest.mark.parametrize("phase", [0, 1, 7, 15, 16, 31])
def test_gather_window_T_matches_jax(phase):
    """Phase realignment of packed words, both the ph == 0 branch and odd
    phases, with interior N bases."""
    rng = np.random.default_rng(phase + 1)
    L, P, n_rows = 4096, 64, 256
    codes = _codes(rng, L)
    start = (rng.integers(0, (L - n_rows) // 32, P) * 32 + phase).astype(np.int32)
    start[:3] = [phase, L - n_rows - 32 + phase, 0]
    jw, jn = jdev._pack_words(jnp.asarray(codes))
    tw, tn = tdev._pack_words(torch.from_numpy(codes))
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_array_equal(_np(tn), _np(jn))
    ref = np.asarray(jdev._gather_window_T(jw, jn, jnp.asarray(start), n_rows))
    got = tdev._gather_window_T(tw, tn, torch.from_numpy(start), n_rows)
    np.testing.assert_array_equal(got.numpy(), ref)


def _meta(rng, L, P, bucket, band):
    q_start = rng.integers(0, L - bucket - 1, P).astype(np.int32)
    m = rng.integers(0, bucket + 1, P).astype(np.int32)
    t_start = rng.integers(0, L - bucket - band - 1, P).astype(np.int32)
    t_lo = np.maximum(t_start - 5, 0).astype(np.int32)
    t_hi = np.minimum(t_start + rng.integers(50, bucket + band, P), L)
    return np.stack([q_start, m, t_start, t_lo, t_hi.astype(np.int32)])


def test_prep_v3_windows_packed_matches_jax():
    rng = np.random.default_rng(5)
    L, P, bucket, band = 4096, 128, 256, 128
    reads2, panel = _codes(rng, L), _codes(rng, L)
    meta = _meta(rng, L, P, bucket, band).astype(np.int32)
    jw = jdev._pack_words(jnp.asarray(reads2)) + jdev._pack_words(jnp.asarray(panel))
    tw = tdev._pack_words(torch.from_numpy(reads2)) + tdev._pack_words(
        torch.from_numpy(panel)
    )
    ref = jdev._prep_v3_windows_packed(*jw, jnp.asarray(meta), bucket, band)
    got = tdev._prep_v3_windows_packed(*tw, torch.from_numpy(meta), bucket, band)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int8 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_prep_v3_flat_matches_jax():
    """Flat meta blocks, their one-copy upload and the per-batch slicing."""
    rng = np.random.default_rng(6)
    L, bucket, band = 4096, 128, 128
    reads2, panel = _codes(rng, L), _codes(rng, L)
    blocks, plans, off = [], [], 0
    for Ppad, nv, bounds in ((128, 5, None), (256, 250, np.array([90, 128]))):
        meta = _meta(rng, L, Ppad, bucket, band).astype(np.int32)
        jblock = jdev.flat_meta_block(meta, nv, bounds)
        tblock = tdev.flat_meta_block(meta, nv, bounds)
        np.testing.assert_array_equal(tblock, jblock)
        assert tdev.flat_block_len(Ppad) == jdev.flat_block_len(Ppad)
        blocks.append(tblock)
        plans.append((off, Ppad))
        off += tdev.flat_block_len(Ppad)
    jflat = jdev.upload_flat_meta(blocks)
    tflat = tdev.upload_flat_meta(blocks, CPU)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    jw = jdev._pack_words(jnp.asarray(reads2)) + jdev._pack_words(jnp.asarray(panel))
    tw = tdev._pack_words(torch.from_numpy(reads2)) + tdev._pack_words(
        torch.from_numpy(panel)
    )
    for off_b, Ppad in plans:
        ref = jdev._prep_v3_flat(*jw, jflat, off_b, Ppad, bucket, band)
        got = tdev._prep_v3_flat(*tw, tflat, off_b, Ppad, bucket, band)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("engine", ["gather", "dma"])
def test_window_score_matches_jax(engine):
    """``gather`` is exact against JAX's gather engine; ``dma`` against the
    JAX fused-fetch kernel in interpret mode. Both entry points: the five
    vectors (dict out) and the packed (5, P) meta (P, 5 out)."""
    from svjedi_tpu.kernels.band_dp_dma import band_dp_dma_raw
    from test_torch_band_dp_dma import layout

    bucket, band, P = 128, 128, 16
    jd, td, vecs = layout(9, P, bucket, band)
    q_start, t_start, m, t_lo, t_hi = vecs
    meta = np.stack([q_start, m, t_start, t_lo, t_hi])
    assert tdev.META_ROWS == jdev.META_ROWS and tdev.OUT_COLS == jdev.OUT_COLS
    if engine == "gather":
        ref = np.asarray(jdev.window_score_packed(
            jd.reads2, jd.panel_padded, jnp.asarray(meta), bucket=bucket,
            band=band, params=JaxDPParams(), engine="gather"))
    else:
        ref = np.asarray(band_dp_dma_raw(
            jd.reads2, jd.panel_padded, *vecs, bucket=bucket, band=band,
            params=JaxDPParams(), interpret=True))[:, :5]
    packed = tdev.window_score_packed(td.reads2, td.panel_padded,
                                      torch.from_numpy(meta), bucket, band,
                                      DPParams(), engine)
    assert packed.shape == (P, 5) and packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), ref)
    T = (torch.from_numpy(v) for v in (q_start, m, t_start, t_lo, t_hi))
    res = tdev.window_score(td.reads2, td.panel_padded, *T, bucket=bucket,
                            band=band, params=DPParams(), engine=engine)
    for c, key in enumerate(tdev.OUT_COLS):
        np.testing.assert_array_equal(res[key].numpy(), ref[:, c], err_msg=key)


def test_window_score_rejects_unknown_engine():
    z = torch.zeros(8, dtype=torch.int32)
    buf = torch.full((2048,), 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="engine"):
        tdev.window_score(buf, buf, z, z, z, z, z, bucket=128, band=128,
                          params=DPParams(), engine="v3")


def test_band_dp_stats_batch_matches_jax():
    """The audit DP (band 256, as compute_winner_stats runs it)."""
    rng = np.random.default_rng(8)
    P, M, B = 48, 160, 256
    q = rng.integers(0, 4, size=(P, M)).astype(np.int8)
    t = np.full((P, M + B), 4, dtype=np.int8)
    for p in range(P):
        copy = q[p].copy()
        flips = rng.random(M) < 0.12
        copy[flips] = rng.integers(0, 4, int(flips.sum()))
        copy = np.delete(copy, rng.integers(0, M, 4))
        copy = np.insert(copy, rng.integers(0, len(copy), 4),
                         rng.integers(0, 4, 4).astype(np.int8))
        off = int(rng.integers(0, B))
        n = min(len(copy), M + B - off)
        t[p, off : off + n] = copy[:n]
    q[0] = 4
    t[1] = 4
    q[2, 100:] = 4
    ref = jax_stats(q, t, B, JaxDPParams())
    got = band_dp_stats_batch(torch.from_numpy(q), torch.from_numpy(t), B,
                              DPParams())
    for key in ("score", "matches", "n_diag", "qe", "te"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
