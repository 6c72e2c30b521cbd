"""The attention kernels' share of their roofline: the bound time of the
attention work a step needs (`work.attention_work`: forward 2 products,
backward 4, each input read once and each output written once, bf16) over
the card time a step of the kernels that implement it, in %. The kernels
are found by name: the port's packed-QKV and resident kernels and
PyTorch's scaled-dot-product ones. No such kernel in the slice: nothing."""

import re

from portbench import work

PATTERN = re.compile(
    r"\battn_(fwd|bwd)|\bres_(fwd|bwd)_tma|flash_(fwd|bwd)|fmha|"
    r"efficient_attention|scaled_dot_product|cudnn.*(sdpa|mha)")


def read(rec: dict):
    dev = rec["device"]
    if dev is None:
        return None
    seconds = sum(s for name, s in dev["op_seconds"].items()
                  if PATTERN.search(name)) / dev["steps"]
    if seconds <= 0:
        return None
    bound = 0.0
    for a in rec["attention"]:
        for backward in (False, True):
            flops, nbytes = work.attention_work(a["seqs"], a["heads"], a["n"],
                                                a["dh"], backward)
            bound += a["layers"] * work.bound_seconds(flops, nbytes)
    return 100.0 * bound / seconds
