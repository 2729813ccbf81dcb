"""Variation graph: SV parsing, graph build and the allele-path panel (copied from svjedi_tpu.graph)."""
