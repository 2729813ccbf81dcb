"""Distribution layer; so far only the genomic-range decoy shards (copied from svjedi_tpu.dist)."""
