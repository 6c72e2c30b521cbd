"""The readings that a cell's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 \
        --fault 3 [--model-control N] [--first-seed N] [--out FILE]

For each seed, at the cell's own sizes: the program's check steps against
the float32 reference (the sound runs, whose largest reading is a limit's
lower end); on the first `--control` seeds the control, the reference put
in the program's place and computed in fp8 (e4m3 operands, e5m2 gradients,
float32 sums), and on the first `--model-control` seeds the same with
the augmentation in float32 (the model's layers alone in fp8); on the
first `--fault` seeds the program with half of each
batch left out, the mean taken over the rest. One JSON line a reading, then
a summary: per number the sound runs' largest, each control's and the
fault's smallest; `--out` also keeps each leaf's norms. A state left unchanged reads 1 on `change_gap` by its
definition and needs no run. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def half_batch(prog):
    """The fault: each step sees the first half of its batch only."""
    step = prog.step

    def broken(i, batch):
        return step(i, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    prog.step = broken
    return prog


def readings(c: dict, seed: int, device, fault: bool = False) -> tuple:
    """The program's check-step readings from `seed` (with the half-batch
    fault if asked), and the seed's traffic."""
    from portbench import harness
    data, prog = harness.build(c, seed, device)
    if fault:
        half_batch(prog)
    out = harness.check_steps(prog, data, c["cfg"]["optimizer"]["b1"])
    del prog
    harness.release_memory()
    return out, data


def calibrate(c: dict, seeds: int, control: int, fault: int,
              first_seed: int, device, model_control: int = 0
              ) -> tuple[list, dict]:
    """The reading lines of `seeds` seeds (the first `control` with the
    control, the first `model_control` with the model-only control, the
    first `fault` with the fault) and their summary."""
    from portbench import harness
    lines = []
    for k in range(seeds):
        seed = first_seed + 7919 * k
        prog, data = readings(c, seed, device)
        w = harness.reference_weights(c, seed, device)
        ref = c["reference"].readings(c["cfg"], c["traffic"], data, w, seed,
                                      harness.CHECK_STEPS)
        runs = [("sound", prog)]
        for kind, count, precision in (("control", control, "fp8"),
                                       ("model_control", model_control,
                                        "fp8_model")):
            if k < count:
                runs.append((kind, c["reference"].readings(
                    c["cfg"], c["traffic"], data, w, seed,
                    harness.CHECK_STEPS, precision=precision)))
        del w
        harness.release_memory()
        if k < fault:
            runs.append(("half_batch", readings(c, seed, device, True)[0]))
        for kind, r in runs:
            line = {"kind": kind, "seed": seed, **harness.gaps(r, ref),
                    "losses": r["losses"], "ref_losses": ref["losses"]}
            print(json.dumps(line), flush=True)
            # each leaf's norms, program and reference, for finding a cause
            line["leaves"] = {k: {n: [r[k][n], ref[k][n]] for n in ref[k]}
                              for k in ("grad_norms", "change_norms")}
            lines.append(line)
        del data
        harness.release_memory()
    summary = {}
    for key in lines[0]:
        if not key.endswith("_gap"):
            continue
        by = lambda kind: [ln[key] for ln in lines if ln["kind"] == kind]
        summary[key] = {"sound_max": max(by("sound")),
                        "sound_median": statistics.median(by("sound")),
                        **{f"{kind}_min": min(by(kind), default=None)
                           for kind in ("control", "model_control",
                                        "half_batch")}}
    return lines, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", type=int, default=3)
    p.add_argument("--model-control", type=int, default=0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 7)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.run import CACHE, CACHE_VARS
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    c = harness.load_cell(args.workload, harness.load_benchmark())
    lines, summary = calibrate(c, args.seeds, args.control, args.fault,
                               args.first_seed, "cuda", args.model_control)
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lines": lines, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
