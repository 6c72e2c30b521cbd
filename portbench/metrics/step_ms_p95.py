"""The 95th percentile of the window's step intervals, each between two
CUDA events recorded after consecutive steps without waiting for them."""

from portbench.harness import p95


def read(rec: dict):
    return p95(rec["window"]["step_ms"])
