"""Evaluation: truth-vs-prediction genotype concordance (copied from svjedi_tpu.evals)."""
