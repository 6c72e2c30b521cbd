"""Operations on the card (kernels, copies and memsets) in the CUDA-only
profiler slice, over its steps."""


def read(rec: dict):
    dev = rec["device"]
    if dev is None:
        return None
    return dev["launches"] / dev["steps"]
