"""Host utilities: run statistics and the native host library (copied from svjedi_tpu.utils)."""
