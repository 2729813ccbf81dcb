"""svjedi-tpu on PyTorch + CUDA: the genotyping pipeline ported to an NVIDIA H100.

The JAX package :mod:`svjedi_tpu` stays the reference. This package mirrors
its layout module for module. It holds verbatim copies of the JAX package's
JAX-free host modules (graph, io, genotype, evals, utils, config, seeding,
decoy, the native host library's source) and replaces every device function
with a PyTorch version; the banded DP kernels are hand-written CUDA
(``kernels/csrc``). It imports ``torch`` and nothing of ``jax`` or
:mod:`svjedi_tpu`, and runs on the GPU unless a caller names the CPU.

- :func:`svjedi_tpu_torch.pipeline.run_pipeline` — VCF+FASTA+FASTQ → genotyped VCF.
- ``python -m svjedi_tpu_torch`` — the CLI flags of ``python -m svjedi_tpu``,
  plus ``run --device {cuda,cpu}``.
"""

__version__ = "0.1.0"
