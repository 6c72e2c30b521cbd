"""The parts of a run that every cell shares: finding a cell's files by
name, the set-up steps that the check follows, the measured window, the
profiler's slices, and the comparison that decides `correct`.

A cell `<config>.<traffic>` of BENCHMARK.json finds
- `workloads/<cell>.json`: the traffic and the cell's limits;
- `configs/<config>.json`: the configuration as it is run;
- `configs/<config>.py`: the program's side (weights' names and shapes,
  FLOPs an image, the attention a step needs, `build`);
- `configs/<config>_ref.py`: the plain reference (`readings`);
- `metrics/<metric>.py`: each metric's reader, `read(record)`, which
  returns a number or None when the run holds nothing for it.
"""

from __future__ import annotations

import bisect
import collections
import gc
import importlib
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import inputs
from portbench.reference import plain

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ssl4gie_tpu")
CHECK_STEPS = 3             # the set-up steps that the reference follows
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# ------------------------------------------------------------ finding a cell

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, bench: dict) -> dict:
    """Everything a run of the cell `name` reads, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    if traffic["config"] != cell["config"]:
        raise ValueError(f"{name}: the traffic file names {traffic['config']}"
                         f", BENCHMARK.json {cell['config']}")
    return {"cell": cell, "cfg": cfg, "traffic": traffic,
            "program": importlib.import_module(
                f"portbench.configs.{cell['config']}"),
            "reference": importlib.import_module(
                f"portbench.configs.{cell['config']}_ref"),
            "end_to_end": metrics_for(bench["end_to_end"], name),
            "per_layer": metrics_for(bench["per_layer"], name)}


def metrics_for(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(metric: str):
    return importlib.import_module(f"portbench.metrics.{metric}").read


def forbidden_loaded() -> list:
    """The modules of JAX, flax or the JAX package in this process,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


# ------------------------------------------------------------ the program

def build(c: dict, seed: int, device):
    """The cell's inputs and the program holding the seed's weights."""
    cfg, traffic = c["cfg"], c["traffic"]
    data = inputs.make_traffic(traffic, cfg.get("num_classes"), seed, device)
    weights = inputs.make_weights(c["program"].weight_specs(cfg),
                                  cfg["init_std"], seed, device)
    prog = c["program"].build(cfg, traffic, data, weights, seed, device)
    return data, prog


def reference_weights(c: dict, seed: int, device) -> dict:
    return inputs.make_weights(c["program"].weight_specs(c["cfg"]),
                               c["cfg"]["init_std"], seed, device)


def check_steps(prog, data: dict, b1: float) -> dict:
    """The program's first CHECK_STEPS steps through the window's own call,
    each on another batch of the pool: each step's loss, each leaf's first
    gradient as AdamW holds it after one step (exp_avg / (1 - b1); 0 where
    it holds none) and each leaf's change after the last step, a qkv bias
    as its three thirds (`plain.leaf_norms`)."""
    pool = data["batches"]
    if len(pool) < CHECK_STEPS:
        raise ValueError(f"the pool needs {CHECK_STEPS} batches or more")
    params = dict(prog.model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, grads = [], {}
    for i in range(CHECK_STEPS):
        losses.append(prog.step(i, pool[i]))
        if i == 0:
            held = ((n, prog.optimizer.state.get(p, {}).get("exp_avg"))
                    for n, p in params.items())
            grads = {k: v / (1 - b1) for k, v in plain.norms(
                (n, m if m is not None else torch.zeros(3)) for n, m in held
            ).items()}
    changes = plain.norms((n, p.detach() - start[n])
                          for n, p in params.items())
    del start
    return {"losses": [float(x) for x in losses],
            "grad_norms": grads, "change_norms": changes}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers a cell may compare; its limits say which it does.
    Losses: `loss_gap`, the largest relative gap of a step's loss;
    `loss1_gap`, the first step's. First gradients, per leaf (a qkv bias
    as its thirds) the gap between the program's and the reference's norm
    over the larger of that leaf's reference norm and the median leaf's:
    `grad_gap`, the worst leaf's; `grad_p90_gap`, the 90th percentile
    leaf's (steadier where the worst is a small leaf summed over every
    token, such as `cls_token` or the patch projection's bias).
    `change_gap`: the worst leaf's gap, measured the same way, between the
    changes after the check steps, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's. The others,
    such as the key bias, whose gradient is nought but for round-off under
    softmax, move under AdamW by the full rate where round-off is above
    its eps, as in bfloat16, and hardly at all in float32."""
    def leaf_gaps(p, r, names):
        med = statistics.median(r[n] for n in names)
        out = [abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names]
        return [g if math.isfinite(g) else math.inf for g in out]

    loss = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(prog["losses"], ref["losses"])]
    names = sorted(ref["grad_norms"])
    med_g = statistics.median(ref["grad_norms"][n] for n in names)
    moved = [n for n in names if ref["grad_norms"][n] >= 1e-3 * med_g]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"], names)
    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            "grad_gap": max(grad),
            "grad_p90_gap": sorted(grad)[int(0.9 * len(grad))],
            "change_gap": max(leaf_gaps(prog["change_norms"],
                                        ref["change_norms"], moved))}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """The numbers that the cell's limits name, each beside its limit;
    correct when none is over its limit."""
    checks = {k: {"value": values[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def release_memory() -> None:
    """Give the memory of what the caller dropped back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ the window

def window(prog, data: dict, first: int, seconds: float) -> dict:
    """Steps back to back for `seconds` of the host's clock, each on the
    pool's next batch; the window ends when the card has finished the last.
    An event after each step times each step's interval on the card (on a
    CPU run, which only tests make, the host's clock does)."""
    pool = data["batches"]
    cuda = pool[0]["image"].is_cuda

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []
    i = first
    t0 = time.perf_counter()
    stamps = [stamp()]
    while time.perf_counter() - t0 < seconds:
        losses.append(prog.step(i, pool[i % len(pool)]))
        stamps.append(stamp())
        i += 1
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in zip(stamps, stamps[1:])]
    losses = torch.stack([x.float() for x in losses]).cpu()
    return {"t0": t0, "seconds": t1 - t0, "steps": len(step_ms),
            "step_ms": step_ms, "next": i,
            "failed": int((~torch.isfinite(losses)).sum()),
            "memory_peak_bytes": (torch.cuda.max_memory_allocated() if cuda
                                  else 0)}


# ------------------------------------------------------------ the trace

def profile_steps(prog, data: dict, first: int, steps: int,
                  with_cpu: bool) -> list:
    """The chrome-trace events of `steps` steps under torch.profiler (CUDA
    activity, and with `with_cpu` the host's too), after two steps that it
    records and discards, which take its start-up cost. The host waits for
    the card only before the first and after the last recorded step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu
                                      else [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    pool = data["batches"]
    try:
        torch.cuda.synchronize()
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=2, active=steps),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) \
                as prof:
            for k in range(steps + 2):
                i = first + k
                prog.step(i, pool[i % len(pool)])
                if k in (1, steps + 1):
                    torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def device_intervals(events: list) -> list:
    """(start_us, end_us, name, correlation) of every operation on the
    card, by start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", ""), e.get("args", {}).get("correlation"))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(out)


def union(intervals: list) -> list:
    merged = []
    for s, e, *_ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_record(events: list, steps: int) -> dict:
    """From a CUDA-only slice: the card's busy and spanned seconds, each
    operation's seconds, and the launches."""
    ops = device_intervals(events)
    if not ops:
        raise RuntimeError("the profiler recorded no operation on the card")
    busy = sum(e - s for s, e in union(ops)) * 1e-6
    span = (max(e for _, e, *_ in ops) - ops[0][0]) * 1e-6
    by_name = collections.Counter()
    for s, e, name, _ in ops:
        by_name[name] += (e - s) * 1e-6
    return {"steps": steps, "busy_s": busy, "window_s": span,
            "launches": len(ops), "op_seconds": dict(by_name)}


def idle_gaps(events: list, top: int = 10) -> list:
    """From a slice with the host's activity: the card's idle gaps summed
    by what the host was doing when it launched the operation that ended
    each gap (the innermost host op around that launch)."""
    ops = device_intervals(events)
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                         "cuda_driver")
              and "correlation" in e.get("args", {})}
    host = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            host[e.get("tid")].append((float(e["ts"]),
                                       float(e["ts"]) + float(e["dur"]),
                                       e["name"]))
    for v in host.values():
        v.sort()
    starts = {tid: [s for s, _, _ in v] for tid, v in host.items()}

    def doing(corr) -> str:
        rt = launch.get(corr)
        if rt is None:
            return "unknown"
        t, tid = float(rt["ts"]), rt.get("tid")
        v = host.get(tid, [])
        k = bisect.bisect_right(starts.get(tid, []), t) - 1
        while k >= 0:
            if v[k][1] >= t:
                return v[k][2]
            k -= 1
        return rt.get("name", "unknown")

    sums = collections.Counter()
    end = None
    for s, e, _, corr in ops:
        if end is not None and s > end:
            sums[doing(corr)] += (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return [[name[:120], sec] for name, sec in sums.most_common(top)]


def breakdown(dev: dict, gaps_: list, top: int = 10) -> dict:
    per_step = sorted(((n, s / dev["steps"]) for n, s in
                       dev["op_seconds"].items()), key=lambda x: -x[1])
    return {"device_ops": [[n[:120], s] for n, s in per_step[:top]],
            "idle_gaps": gaps_}


def p95(values: list) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]
