"""Genotyping: support filtering, likelihood model and VCF output (copied from svjedi_tpu.genotype)."""
