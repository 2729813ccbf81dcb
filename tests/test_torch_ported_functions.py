"""The JAX package's remaining functions in the port vs their originals.

- ``align/extend.py:smith_waterman_full``, the exact O(mn) oracle: equal to
  JAX's on random problems, and the plain ``band_dp_batch`` equal to it on
  problems a wide band contains (as ``tests/test_band_dp.py`` holds JAX's);
- ``align/pipeline.py:build_problem_batches`` and ``align_candidates`` on a
  simulated genome: batches and winners equal to JAX's;
- ``align/device.py:_prep_v3_windows``, ``window_score_v3_fwd`` and
  ``window_score_v3_rev``: windows and outputs equal to JAX's (its v3
  kernel in interpret mode, as ``tests/test_band_dp_v3.py`` runs it).

Every comparison is exact; the port runs its plain versions on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svjedi_tpu.align import device as jdev
from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.align.extend import smith_waterman_full as jax_sw
from svjedi_tpu.kernels import band_dp_v3 as jax_v3
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.align.extend import (
    DPParams, band_dp_batch, smith_waterman_full,
)
from test_torch_align import WINNER_FIELDS, bundle  # noqa: F401
from test_torch_band_dp_dma import layout
from test_torch_dev_scan import native_installed

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: Score sets: the defaults, a zero gap open, a positive mismatch.
SCORES = ({}, dict(gap_open=2, gap_extend=-2), dict(mismatch=1))


def _mutate(rng, seq, rate=0.08):
    """Substitutions, insertions and deletions at ``rate`` each."""
    out = []
    for c in seq:
        r = rng.random()
        if r < rate:
            continue
        if r < 2 * rate:
            out.append(int(rng.integers(0, 4)))
        out.append(int((c + rng.integers(1, 4)) % 4) if r > 1 - rate else c)
    return np.array(out, dtype=np.int8)


def _sw_problem(seed: int):
    """A read holding a mutated stretch of the target between random
    flanks, with an N here and there."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, int(rng.integers(30, 90))).astype(np.int8)
    a, b = sorted(rng.integers(0, len(t), 2))
    b = max(b, min(len(t), a + 12))
    q = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 8))),
                        _mutate(rng, t[a:b]),
                        rng.integers(0, 4, int(rng.integers(0, 8)))])
    q = q.astype(np.int8)
    q[rng.random(len(q)) < 0.03] = 4
    return q, t


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scores", SCORES, ids=["defaults", "oe=0",
                                                "mismatch=1"])
def test_smith_waterman_full_matches_jax(seed, scores):
    q, t = _sw_problem(seed)
    assert smith_waterman_full(q, t, DPParams(**scores)) == \
        jax_sw(q, t, JaxDPParams(**scores))


@pytest.mark.parametrize("seed", range(6))
def test_band_dp_batch_matches_smith_waterman_full(seed):
    """A band wide enough to hold the whole matrix: the score is the exact
    optimum, and the reported span holds an alignment of that score."""
    params = DPParams()
    q, t = _sw_problem(100 + seed)
    m, n = len(q), len(t)
    band = 1
    while band < m + n + 2:
        band *= 2
    t_pad = np.full(m + band, 4, dtype=np.int8)
    t_pad[m:m + n] = t
    out = band_dp_batch(torch.from_numpy(q[None]), torch.from_numpy(
        t_pad[None]), band, params)
    got = {k: int(v[0]) for k, v in out.items()}
    exact = smith_waterman_full(q, t, params)
    assert got["score"] == exact[0] > 0
    qs, qe, ts, te = got["qs"], got["qe"], got["ts"] - m, got["te"] - m
    assert 0 <= qs <= qe < m and 0 <= ts <= te < n
    assert smith_waterman_full(q[qs:qe + 1], t[ts:te + 1], params)[0] == \
        exact[0]


def _seeded(bundle):
    """Each package's candidates from its own seeding, on the numpy host
    path (the packages' native and numpy chainers differ in a few
    candidates)."""
    from svjedi_tpu.utils import native as jnative
    from svjedi_tpu_torch.utils import native as tnative

    out = {}
    with native_installed(None, jnative, tnative):
        for pkg, b in bundle.items():
            out[pkg] = b["seed"].seed_candidates(
                b["reads"], b["index"],
                chain_params=b["seed"].ChainParams())
    return out


def test_build_problem_batches_matches_jax(bundle):  # noqa: F811
    """The same batches, and the plain one-pass DP on them equal to JAX's."""
    from svjedi_tpu.align.extend import band_dp_batch as jax_band_dp_batch

    cands = _seeded(bundle)
    args = {pkg: (b["reads"], b["panel"], b["index"], cands[pkg], b["cfg"])
            for pkg, b in bundle.items()}
    ours = list(tpipe.build_problem_batches(*args["svjedi_tpu_torch"],
                                            batch_size=64))
    theirs = list(jpipe.build_problem_batches(*args["svjedi_tpu"],
                                              batch_size=64))
    assert len(ours) == len(theirs) > 1
    for o, t in zip(ours, theirs):
        for a, b in zip(o, t):
            np.testing.assert_array_equal(a, b)
    band = bundle["svjedi_tpu"]["cfg"].band
    _, q, t, _, _ = ours[0]
    got = band_dp_batch(torch.from_numpy(q), torch.from_numpy(t), band)
    ref = jax_band_dp_batch(q, t, band, JaxDPParams())
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


def test_align_candidates_matches_jax(bundle):  # noqa: F811
    """Winners of the default engine (``gather`` on the CPU), all exact."""
    cands = _seeded(bundle)
    j, t = bundle["svjedi_tpu"], bundle["svjedi_tpu_torch"]
    theirs = jpipe.align_candidates(j["reads"], j["panel"], j["index"],
                                    cands["svjedi_tpu"], j["cfg"])
    ours = tpipe.align_candidates(t["reads"], t["panel"], t["index"],
                                  cands["svjedi_tpu_torch"], t["cfg"],
                                  device=CPU)
    assert len(ours.read) == len(theirs.read) > 50
    for f in WINNER_FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)


def test_align_candidates_needs_a_card_unless_given_the_cpu(bundle,  # noqa: F811
                                                             monkeypatch):
    t = bundle["svjedi_tpu_torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.align_candidates(t["reads"], t["panel"], t["index"],
                               _seeded(bundle)["svjedi_tpu_torch"], t["cfg"])


def test_prep_v3_windows_matches_jax():
    """Inline packing of both buffers, then the window prep."""
    rng = np.random.default_rng(3)
    L, P, bucket, band = 4096, 128, 256, 128
    reads2 = rng.integers(0, 4, L, dtype=np.int8)
    reads2[rng.random(L) < 0.02] = 4
    panel = rng.integers(0, 4, L, dtype=np.int8)
    panel[:40] = 4
    q_start = rng.integers(0, L - bucket - 1, P)
    m = rng.integers(10, bucket + 1, P)
    t_start = rng.integers(0, L - bucket - band - 1, P)
    t_lo = np.maximum(t_start - 5, 0)
    t_hi = np.minimum(t_start + rng.integers(50, bucket + band, P), L)
    meta = np.stack([q_start, m, t_start, t_lo, t_hi]).astype(np.int32)
    ref = jdev._prep_v3_windows(jnp.asarray(reads2), jnp.asarray(panel),
                                jnp.asarray(meta), bucket, band)
    got = tdev._prep_v3_windows(torch.from_numpy(reads2),
                                torch.from_numpy(panel),
                                torch.from_numpy(meta), bucket, band)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n_valid", [None, 100])
def test_window_score_v3_fwd_and_rev_match_jax(monkeypatch, n_valid):
    """Forward pass on the uploads' windows, then the reverse pass on the
    end-clamped windows (m' = qe + 1, t_hi' = t_start + te + 1) that the
    dispatcher gives it."""
    for name in ("band_dp_v3_fwd_jit", "band_dp_v3_rev_jit"):
        monkeypatch.setattr(jax_v3, name, functools.partial(
            getattr(jax_v3, name), interpret=True))
    bucket, band, P = 128, 128, 128
    jd, td, (q_start, t_start, m, t_lo, t_hi) = layout(21, P, bucket, band)
    meta = np.stack([q_start, m, t_start, t_lo, t_hi]).astype(np.int32)
    fwd = tdev.window_score_v3_fwd(td, torch.from_numpy(meta), bucket, band,
                                   DPParams(), n_valid)
    ref = jdev.window_score_v3_fwd(jd, jnp.asarray(meta), bucket, band,
                                   JaxDPParams(), n_valid)
    # Problems at or past n_valid are unspecified in JAX; the port reports
    # them unscored.
    n = P if n_valid is None else n_valid
    np.testing.assert_array_equal(fwd[:n].numpy(), np.asarray(ref)[:n])
    assert (fwd[n:].numpy() == [0, -1, -1]).all()
    assert (fwd[:, 0] > 0).sum() > n // 2
    score, qe, te = (fwd[:, c].numpy() for c in range(3))
    live = score > 0
    rmeta = meta.copy()
    rmeta[1] = np.where(live, qe + 1, 0)
    rmeta[4] = np.where(live, t_start + te + 1, t_hi)
    rev = tdev.window_score_v3_rev(td, torch.from_numpy(rmeta), bucket, band,
                                   DPParams(), n_valid)
    rref = jdev.window_score_v3_rev(jd, jnp.asarray(rmeta), bucket, band,
                                    JaxDPParams(), n_valid)
    np.testing.assert_array_equal(rev[:n].numpy(), np.asarray(rref)[:n])
    assert (rev[n:].numpy() == [0, bucket, bucket + band - 1]).all()
    np.testing.assert_array_equal(rev[:n, 0].numpy(), score[:n])
