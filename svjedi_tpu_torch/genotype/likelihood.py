# Copied verbatim from svjedi_tpu/genotype/likelihood.py.
"""Binomial genotype-likelihood model (reference: predict-genotype.py:281-346).

Two implementations with identical math:

- :func:`genotype_one` — host scalar path used by the VCF writer; reproduces
  the reference's arithmetic (including Python ``round`` banker's rounding in
  the unbalanced-SV normalization, int truncation of PL, and tie → ``./.``)
  so output is byte-identical.
- :func:`genotype_batch` — vectorized jnp float64-free version for on-device
  analytics at scale (PL values match the host path for all realistic counts;
  validated in tests).

Model per SV with (c1, c2) = informative alignments per allele:
    L(0/0) = c1·log10(1-e) + c2·log10(e)
    L(0/1) = (c1+c2)·log10(1/2)
    L(1/1) = c2·log10(1-e) + c1·log10(e)
GT = argmax (tie → ./.), total support < min_support → ./.,
PL_i = int(-10·(L_i + log10 C(rc1+rc2, rc1))) with rc = rounded counts.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def normalize_counts(counts: Sequence[float], svtype: str) -> List[float]:
    """Halve (round, 1 decimal) the 2-breakpoint allele count of DEL/INS.

    Reference: predict-genotype.py:327-338 (DEL → ref allele halved, INS →
    alt allele halved; other types untouched). Uses Python ``round`` to keep
    banker's-rounding parity.
    """
    counts = list(counts)
    if svtype == "DEL":
        idx = 0
    elif svtype == "INS":
        idx = 1
    else:
        return counts
    if counts[idx] > 0:
        counts[idx] = round(counts[idx] / 2, 1)
    return counts


def genotype_one(
    counts: Sequence[float],
    svtype: str,
    min_support: int,
    err: float,
) -> Tuple[str, List[str], List[float]]:
    """Genotype one SV; returns (GT, PL strings, normalized counts).

    Mirrors predict-genotype.py:281-325: normalization happens in place and
    is visible in the caller's DP/AD (the returned normalized counts);
    min-support is tested on the *normalized* sum (``all_count`` after the
    in-place mutation at :286).
    """
    counts = normalize_counts(counts, svtype)
    c1, c2 = counts
    rc1, rc2 = int(round(c1, 0)), int(round(c2, 0))

    lik0 = c1 * math.log10(1 - err) + c2 * math.log10(err)
    lik1 = (c1 + c2) * math.log10(0.5)
    lik2 = c2 * math.log10(1 - err) + c1 * math.log10(err)
    liks = [lik0, lik1, lik2]

    best = max(liks)
    argmax = [i for i, x in enumerate(liks) if x == best]
    if len(argmax) == 1:
        geno = ("0/0", "0/1", "1/1")[argmax[0]]
    else:
        geno = "./."
    if not sum(counts) >= min_support:
        geno = "./."

    comb = math.log10(math.comb(rc1 + rc2, rc1))
    pl = [str(int(-10 * (lik + comb))) for lik in liks]
    return geno, pl, counts


def genotype_batch(
    counts: np.ndarray,
    svtypes: np.ndarray,
    min_support: int,
    err: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized genotyping.

    Args:
        counts: float64 ``(n, 2)`` raw allele counts.
        svtypes: int8 ``(n,)`` with 0=DEL, 1=INS, other=balanced.
        min_support / err: model knobs.

    Returns ``(gt, pl, norm_counts)`` where gt is int8 (0, 1, 2, or -1 for
    ``./.``), pl is int64 ``(n, 3)``, norm_counts float64 ``(n, 2)``.
    """
    counts = np.asarray(counts, dtype=np.float64).copy()
    n = counts.shape[0]

    halve_ref = svtypes == 0
    halve_alt = svtypes == 1
    # np.round is banker's rounding like Python round.
    c0 = counts[:, 0]
    c1 = counts[:, 1]
    c0 = np.where(halve_ref & (c0 > 0), np.round(c0 / 2, 1), c0)
    c1 = np.where(halve_alt & (c1 > 0), np.round(c1 / 2, 1), c1)
    norm = np.stack([c0, c1], axis=1)

    l0 = c0 * math.log10(1 - err) + c1 * math.log10(err)
    l1 = (c0 + c1) * math.log10(0.5)
    l2 = c1 * math.log10(1 - err) + c0 * math.log10(err)
    liks = np.stack([l0, l1, l2], axis=1)

    best = liks.max(axis=1, keepdims=True)
    is_max = liks == best
    unique_max = is_max.sum(axis=1) == 1
    gt = np.where(unique_max, liks.argmax(axis=1), -1).astype(np.int8)
    gt = np.where(norm.sum(axis=1) >= min_support, gt, -1).astype(np.int8)

    rc = np.round(norm).astype(np.int64)
    comb = np.array(
        [math.log10(math.comb(int(a + b), int(a))) for a, b in rc],
        dtype=np.float64,
    )
    pl = (-10 * (liks + comb[:, None])).astype(np.int64)
    return gt, pl, norm
