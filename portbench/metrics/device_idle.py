"""The card's idle share over a CUDA-only profiler slice of steps: 1 minus
the union of its operations' intervals over the span from the first
operation's start to the last one's end, in %."""


def read(rec: dict):
    dev = rec["device"]
    if dev is None:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
