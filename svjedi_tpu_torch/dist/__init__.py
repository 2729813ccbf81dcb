"""Distribution layer: device mesh, sharded count steps, the count merges, and the decoy shards (copied from svjedi_tpu.dist)."""
