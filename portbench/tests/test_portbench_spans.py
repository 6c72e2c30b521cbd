"""`portbench/spans.py` on a synthetic trace, on the CPU.

    python -m pytest portbench/tests -q
"""

import pytest

from portbench import spans


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


TRACE = [
    _x("user_annotation", "ProfilerStep#0", 0, 1000),
    _x("user_annotation", "ssl4gie.step", 10, 900),
    _x("user_annotation", "ssl4gie.augment", 20, 80),
    _x("user_annotation", "ssl4gie.forward", 100, 200),
    _x("user_annotation", "ssl4gie.backward", 300, 300),
    _x("user_annotation", "ssl4gie.optimizer", 600, 200),
    _x("cpu_op", "aten::copy_", 40, 20),
    _launch(50, 1),                       # augment
    _launch(150, 2),                      # forward
    _launch(400, 3, tid=2),               # backward, from autograd's thread
    _launch(700, 4),                      # optimizer
    _launch(850, 5),                      # the step, in no child
    _launch(950, 6),                      # only in ProfilerStep#0
    _x("kernel", "crop", 60, 30, corr=1),
    _x("kernel", "gemm", 200, 50, corr=2),          # after 110 idle
    _x("kernel", "gemm_bwd", 250, 100, corr=3),     # no gap
    _x("gpu_memset", "Memset", 360, 20, corr=4),    # after 10 idle
    _x("kernel", "add", 900, 10, corr=5),           # after 520 idle
    _x("gpu_memcpy", "Memcpy DtoH", 1000, 5, corr=6),   # after 90 idle
    _x("kernel", "unlaunched", 1002, 10, corr=7),   # its launch unrecorded
]


def test_span_record_sums_each_layer():
    rec = spans.span_record(TRACE, steps=2)
    want = {  # busy us, idle us, launches, over 2 steps
        "augment": (30, 0, 1), "forward": (50, 110, 1),
        "backward": (100, 0, 1), "optimizer": (20, 10, 1),
        "step": (10, 520, 1), "outside": (15, 90, 2)}
    assert rec == {name: {"busy_ms": pytest.approx(b * 1e-3 / 2),
                          "idle_ms": pytest.approx(i * 1e-3 / 2),
                          "launches": n / 2}
                   for name, (b, i, n) in want.items()}
    totals = spans.slice_totals(TRACE, steps=2)
    assert totals == {"window_ms": pytest.approx(952e-3 / 2),
                      "busy_ms": pytest.approx(222e-3 / 2),
                      "idle_ms": pytest.approx(730e-3 / 2)}
    assert sum(r["idle_ms"] for r in rec.values()) == pytest.approx(
        totals["idle_ms"])


def test_without_spans_everything_is_outside():
    bare = [e for e in TRACE if not e["name"].startswith("ssl4gie.")]
    rec = spans.span_record(bare, steps=1)
    assert list(rec) == ["outside"]
    assert rec["outside"]["launches"] == 7
    assert rec["outside"]["busy_ms"] == pytest.approx(225e-3)
    assert rec["outside"]["idle_ms"] == pytest.approx(730e-3)
