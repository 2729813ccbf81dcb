"""Read-to-graph aligner, device half on PyTorch (seeding is shared with svjedi_tpu)."""
