"""svjedi-tpu on PyTorch + CUDA: the genotyping pipeline ported to an NVIDIA H100.

The JAX package :mod:`svjedi_tpu` stays the reference. This package mirrors
its layout module for module, shares its JAX-free host code (graph, io,
genotype, evals, utils, config, seeding, decoy) and replaces every device
function with a PyTorch version; the banded DP kernel is hand-written CUDA
(``kernels/csrc/band_dp_v3.cu``). It imports ``torch`` and never ``jax``.

- :func:`svjedi_tpu_torch.pipeline.run_pipeline` — VCF+FASTA+FASTQ → genotyped VCF.
- ``python -m svjedi_tpu_torch`` — the same CLI flags as ``python -m svjedi_tpu``.
"""

__version__ = "0.1.0"
