"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The run makes the weights and the traffic on the card from the seed,
builds the port's model, optimizer and step entry, takes the first steps
that the check follows, warms up, then steps back to back for `--seconds`.
With `--trace 0` it prints the cell's end-to-end metrics; with `--trace 1`
it then profiles slices of steps and prints the per-layer metrics and a
breakdown. Last, with the program's state freed, the plain reference
follows the first steps and `correct` says whether the program agrees with
it within the cell's limits. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared, each beside its limit.

Without a card (or fewer than the cell asks for), or with JAX, flax or the
JAX package loaded, it exits with a code other than 0 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches: fixed directories in the checkout
CACHE = ROOT / ".portbench_cache"
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(chips: int, memory_peak_bytes: int, device) -> dict:
    """The device field: the card's name, count, peak and power limit (a
    CPU run, which only tests make, says so)."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": memory_peak_bytes}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def run(c: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = T_START) -> dict:
    """One run of the cell `c` (`harness.load_cell`); the result object."""
    from portbench import harness

    cfg, traffic = c["cfg"], c["traffic"]
    data, prog = harness.build(c, seed, device)
    readings = harness.check_steps(prog, data, cfg["optimizer"]["b1"])
    first = harness.CHECK_STEPS
    for i in range(first, first + traffic["warmup_steps"]):
        prog.step(i, data["batches"][i % len(data["batches"])])
    win = harness.window(prog, data, first + traffic["warmup_steps"],
                         seconds)
    rec = {"batch": traffic["batch"], "window": win,
           "setup_s": win["t0"] - t_start,
           "flops_per_image": c["program"].flops_per_image(cfg),
           "attention": c["program"].attention(cfg, traffic["batch"]),
           "device": None}
    result_breakdown = None
    if trace:
        k = traffic["trace_steps"]
        rec["device"] = harness.device_record(harness.profile_steps(
            prog, data, win["next"], k, with_cpu=False), k)
        gaps = harness.idle_gaps(harness.profile_steps(
            prog, data, win["next"] + k + 2, k, with_cpu=True))
        result_breakdown = harness.breakdown(rec["device"], gaps)
    del prog
    harness.release_memory()

    ref = c["reference"].readings(cfg, traffic, data,
                                  harness.reference_weights(c, seed, device),
                                  seed, harness.CHECK_STEPS)
    ok, checks = harness.judge(harness.gaps(readings, ref), traffic["limits"])
    chosen = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in chosen:
        value = harness.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card(c["cell"]["chips"], win["memory_peak_bytes"], device)
    if trace:
        dev["busy_s"] = rec["device"]["busy_s"]
        dev["window_s"] = rec["device"]["window_s"]
    out = {"correct": ok, "attempted": win["steps"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if result_breakdown is not None:
        out["breakdown"] = result_breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    c = harness.load_cell(args.workload, harness.load_benchmark())
    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(c, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"modules that the benchmark may not load are loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
