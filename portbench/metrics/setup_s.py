"""Seconds from the start of the process to the first timed step: imports,
the card's start, the build or load of the kernel library, the weights and
traffic, the model and optimizer, the check steps and the warm-up."""


def read(rec: dict):
    return rec["setup_s"]
