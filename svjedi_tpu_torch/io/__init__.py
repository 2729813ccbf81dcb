"""File formats: FASTA, FASTQ(.gz), GAF, GFA and the simulator (copied from svjedi_tpu.io)."""
