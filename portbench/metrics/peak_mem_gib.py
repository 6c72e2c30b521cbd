"""The card's peak of allocated memory over the window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`)."""


def read(rec: dict):
    return rec["window"]["memory_peak_bytes"] / 2 ** 30
