"""Best-val checkpointing (port of `ssl4gie_tpu/core/checkpoint.py`).

The reference keeps one best-val file per run with the model, optimizer
and scaler state, the epoch and the best val/test metrics
(`train_classification.py:352-366`). Here a slot is one `torch.save` file,
`<ckpt_dir>/<run_name>.pt` (the preemption sibling is
`<run_name>.preempt.pt`), holding the model's `state_dict` (parameters and
BatchNorm buffers), the optimizer's, and the meta the JAX Trainer saves.
A save writes a temporary file, syncs it to disk and renames it over the
slot, so a killed save never leaves a torn slot. The JAX package's orbax
slot is the directory `<ckpt_dir>/<run_name>`, so both packages can share
one `--ckpt-dir`.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def is_primary() -> bool:
    """Rank 0 under `torch.distributed`, else true (only it writes)."""
    dist = torch.distributed
    return (not dist.is_available() or not dist.is_initialized()
            or dist.get_rank() == 0)


def host_copy(tree: Any) -> Any:
    """A copy of `tree` (nested dicts, lists and tuples of tensors and
    plain values) with every tensor copied to the host: a snapshot that
    later in-place updates of the live tensors do not touch."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    """One checkpoint slot, `<directory>/<name>.pt`."""

    def __init__(self, directory: str, name: str):
        self.directory = os.path.abspath(directory)
        self.name = name
        self.path = os.path.join(self.directory, name + ".pt")
        os.makedirs(self.directory, exist_ok=True)

    def exists(self) -> bool:
        return os.path.isfile(self.path)

    def save(self, tree: Any) -> None:
        """Overwrite the slot with `tree` (tensors and plain values)."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def delete(self) -> None:
        """Remove the slot (e.g. a stale .preempt sibling once surpassed)."""
        if self.exists():
            os.remove(self.path)

    def restore(self, map_location=None) -> Any:
        return torch.load(self.path, map_location=map_location,
                          weights_only=True)

    def meta(self) -> dict:
        """The slot's meta, without reading its tensors (memory-mapped)."""
        return torch.load(self.path, map_location="cpu", weights_only=True,
                          mmap=True)["meta"]
