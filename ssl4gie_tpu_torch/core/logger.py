"""Structured metrics logging (port of `ssl4gie_tpu/core/logger.py`):
stdout, a `.txt` and a `.jsonl` per run with the JAX package's payload
keys, the repo-root `eval_results.txt` ledger, and the images/s and
step-time meter.

The reference's per-run `.txt` logs and `eval_results.txt`
(`train_classification.py:51-76`, `eval_classification.py:41-61`) are kept
as they are. Only the primary process writes: rank 0 when
`torch.distributed` is initialised, the one process otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ssl4gie_tpu_torch.core.checkpoint import is_primary


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str, tb: bool = False):
        self.primary = is_primary()
        self.txt_path = os.path.join(log_dir, f"{run_name}.txt")
        self.jsonl_path = os.path.join(log_dir, f"{run_name}.jsonl")
        if self.primary:
            os.makedirs(log_dir, exist_ok=True)
        self._t0 = time.time()
        # the reference's SummaryWriter scalars (`main_pretrain.py:237-239`)
        # through the dependency-free core.tb writer
        self._tb = None
        if tb and self.primary:
            from ssl4gie_tpu_torch.core.tb import SummaryWriter
            self._tb = SummaryWriter(os.path.join(log_dir, "tb", run_name))
        self._tb_step = 0

    def log(self, payload: Dict[str, Any], echo: Optional[str] = None) -> None:
        if not self.primary:
            return
        payload = dict(payload, wall_s=round(time.time() - self._t0, 3))
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(payload, default=float) + "\n")
        if self._tb is not None:
            self._tb_step = int(payload.get("step", payload.get(
                "epoch", self._tb_step + 1)))
            for k, v in payload.items():
                if k not in ("step", "epoch", "wall_s") and isinstance(
                        v, (int, float)):
                    self._tb.add_scalar(k, float(v), self._tb_step)
            self._tb.flush()
        line = echo if echo is not None else " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in payload.items())
        with open(self.txt_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)

    def write_args(self, args: Dict[str, Any]) -> None:
        """Dump the run's arguments at its start (the reference prints them,
        `train_classification.py:282-284`)."""
        if not self.primary:
            return
        with open(self.txt_path, "a") as f:
            f.write(json.dumps(args, default=str) + "\n")


def append_eval_results(root: str, header: str, lines: list[str]) -> None:
    """Append to the shared eval_results.txt ledger under a timestamped
    header, as `eval_classification.py:41-61` does."""
    if not is_primary():
        return
    path = os.path.join(root, "eval_results.txt")
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(path, "a") as f:
        f.write(f"\n[{stamp}] {header}\n")
        for ln in lines:
            f.write(ln + "\n")


class Throughput:
    """images/s and step-time meter (host clock; a step's time is its
    share of the wall time since the last reset)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = time.perf_counter()
        self._images = 0
        self._steps = 0

    def update(self, batch_size: int):
        """One step of `batch_size` images."""
        self._images += batch_size
        self._steps += 1

    def rates(self, remaining_steps: Optional[int] = None) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t, 1e-9)
        out = {"images_per_sec": self._images / dt,
               "step_time_ms": 1000.0 * dt / max(self._steps, 1)}
        if remaining_steps is not None:
            # the epoch's ETA from the running mean step time (the
            # reference MetricLogger's `eta:`, `Models/mae/util/misc.py:140`)
            out["eta_s"] = round(remaining_steps * dt / max(self._steps, 1), 1)
        return out


def peak_memory_mb(device) -> Optional[float]:
    """Peak device memory allocated on `device`, MB (the reference's
    per-epoch `torch.cuda.max_memory_allocated`,
    `Models/mae/util/misc.py:164-167`); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
