"""Read-to-graph aligner on PyTorch: host seeding (copied from svjedi_tpu.align) and the device DP."""
