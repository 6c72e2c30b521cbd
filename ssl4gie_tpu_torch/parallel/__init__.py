"""Multi-process runs: process-group setup, the data-parallel collectives,
tensor parallelism and the placement of a model (DDP, FSDP2, TP)."""
