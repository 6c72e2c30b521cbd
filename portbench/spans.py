"""The program's spans in a profiler slice: the card's time, idle time and
operations of each layer of a step.

The port's step entries run their layers under named host ranges
(`ssl4gie_tpu_torch/core/spans.py`): `ssl4gie.step` around a step, and
inside it `ssl4gie.augment`, `ssl4gie.forward`, `ssl4gie.backward` and
`ssl4gie.optimizer`. `span_record` reads them from a slice with the host's
activity, the one `harness.idle_gaps` reads. From the command line it
profiles slices of a cell's steps on the card and prints one JSON line a
slice:

    python3 portbench/spans.py --workload <cell> --seed <n> [--slices 3]

On a program without spans every operation falls under `outside`.
"""

from __future__ import annotations

import bisect
import collections
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

PREFIX = "ssl4gie."
STEP = "step"
OUTSIDE = "outside"


def span_record(events: list, steps: int) -> dict:
    """For each layer, per step: `busy_ms`, the card time of the operations
    launched inside its innermost span (their durations summed, as
    `harness.device_record` sums each name's); `idle_ms`, the card's idle
    gaps, each put down to the span that launched the operation ending it
    (the gaps of `harness.idle_gaps`); and `launches`. A launch is found by
    its correlation, on any of the process's threads (the backward's come
    from autograd's device thread), and falls in the span of any thread
    whose host interval holds it. Operations launched in `ssl4gie.step`
    but in none of its children count under `step`, those in no span under
    `outside`. Layers without operations or gaps are left out."""
    ops = harness.device_intervals(events)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                         "cuda_driver")
              and "correlation" in e.get("args", {})}
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(PREFIX):]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX))
    starts = [s for s, _, _ in ranges]

    def layer(corr) -> str:
        """The innermost span holding the launch: of the spans that do,
        the one that started last."""
        t = launch.get(corr)
        if t is None:
            return OUTSIDE
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0:
            if ranges[k][1] >= t:
                return ranges[k][2]
            k -= 1
        return OUTSIDE

    busy = collections.Counter()
    idle = collections.Counter()
    count = collections.Counter()
    end = None
    for s, e, _, corr in ops:
        name = layer(corr)
        busy[name] += e - s
        count[name] += 1
        if end is not None and s > end:
            idle[name] += s - end
        end = e if end is None else max(end, e)
    return {name: {"busy_ms": busy[name] * 1e-3 / steps,
                   "idle_ms": idle[name] * 1e-3 / steps,
                   "launches": count[name] / steps}
            for name in sorted(set(busy) | set(idle))}


def slice_totals(events: list, steps: int) -> dict:
    """The slice's card time per step: the span from the first operation's
    start to the last one's end, the union of the operations, and the
    idle time between them."""
    ops = harness.device_intervals(events)
    busy = sum(e - s for s, e in harness.union(ops))
    window = max(e for _, e, *_ in ops) - ops[0][0]
    return {"window_ms": window * 1e-3 / steps, "busy_ms": busy * 1e-3 / steps,
            "idle_ms": (window - busy) * 1e-3 / steps}


def main(argv=None) -> int:
    import argparse
    import json
    import os

    import torch

    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--slices", type=int, default=3)
    args = p.parse_args(argv)
    for var, sub in run.CACHE_VARS.items():
        os.environ[var] = str(run.CACHE / sub)
    if not torch.cuda.is_available():
        print("the slices need a CUDA device", file=sys.stderr)
        return 2
    c = harness.load_cell(args.workload, harness.load_benchmark())
    k = c["traffic"]["trace_steps"]
    data, prog = harness.build(c, args.seed, "cuda")
    first = harness.CHECK_STEPS + c["traffic"]["warmup_steps"]
    for i in range(first):
        prog.step(i, data["batches"][i % len(data["batches"])])
    card = torch.cuda.get_device_name(0)
    for n in range(args.slices):
        events = harness.profile_steps(prog, data, first, k, with_cpu=True)
        first += k + 2
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "slice": n, "steps": k, "card": card,
                          **slice_totals(events, k),
                          "spans": span_record(events, k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
