"""Command-line entry points (ports of `ssl4gie_tpu/cli`)."""
