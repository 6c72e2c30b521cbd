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

A placed model (DDP, FSDP2, TP: `parallel/tp.py`) saves the full state
under the same names and in the same format as one process, as the JAX
package gathers its sharded trees to the host (`host_tree`):
`state_dicts` gathers it on every rank (a collective) and rank 0 writes.
`load_state_dicts` places a full state into a model of any placement, so
a slot written by W ranks loads into one process and the other way round.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch.nn.parallel import DistributedDataParallel

from ssl4gie_tpu_torch.parallel import distributed as dist_lib
from ssl4gie_tpu_torch.parallel import tp as tp_lib


def is_primary() -> bool:
    """Rank 0 under `torch.distributed`, else true (only it writes)."""
    return dist_lib.is_primary()


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


def _placed(model: torch.nn.Module) -> bool:
    from torch.distributed.tensor import DTensor
    return (isinstance(model, DistributedDataParallel)
            or tp_lib.tp_info(model) is not None
            or any(isinstance(p, DTensor) for p in model.parameters()))


def _tp_map(tree: dict, fn) -> dict:
    """`tree` (name -> tensor, or name -> {key: state}) with `fn(spec, x)`
    applied to each tensor of a TP-split parameter, whose shape it has."""
    out = {}
    for name, value in tree.items():
        spec = tp_lib.tp_spec(name)
        if spec is None:
            out[name] = value
        elif isinstance(value, dict):
            out[name] = {k: fn(spec, v) if torch.is_tensor(v) and v.ndim
                         else v for k, v in value.items()}
        else:
            out[name] = fn(spec, value)
    return out


def _param_names(model, optimizer) -> list:
    """Each param group's parameter names, in the optimizer's order."""
    names = {id(p): n for n, p in dist_lib.unwrap(model).named_parameters()}
    return [[names[id(p)] for p in g["params"]]
            for g in optimizer.param_groups]


def state_dicts(model: torch.nn.Module, optimizer=None):
    """(model state dict, optimizer state dict or None): host copies of
    the full state, under one process's names and in its format
    (`optimizer.state_dict()`'s numbered parameters). For a placed model
    every rank must call it; the copies are whole on rank 0."""
    if not _placed(model):
        return (host_copy(model.state_dict()),
                None if optimizer is None
                else host_copy(optimizer.state_dict()))
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict)
    info = tp_lib.tp_info(model)
    # under TP every rank needs its whole tensors for the gather below
    opts = StateDictOptions(full_state_dict=True, cpu_offload=info is None)
    msd = get_model_state_dict(model, options=opts)
    osd = None
    if optimizer is not None and not optimizer.state:
        # nothing to gather (and `get_optimizer_state_dict` would take a
        # zero-gradient step to create the state, advancing the step count)
        osd = host_copy(optimizer.state_dict())
    elif optimizer is not None:
        osd = get_optimizer_state_dict(model, optimizer, options=opts)
    if info is not None:
        group, _, size = info

        def gather(spec, x):
            parts = [torch.empty_like(x) for _ in range(size)]
            torch.distributed.all_gather(parts, x.contiguous(), group=group)
            return tp_lib.unshard_tensor(parts, spec)

        msd = _tp_map(msd, gather)
        if osd is not None:
            osd = dict(osd, state=_tp_map(osd["state"], gather))
    if osd and not isinstance(next(iter(
            osd["param_groups"][0]["params"]), 0), int):
        # by name (empty off rank 0 under cpu_offload): to numbers
        index = {n: i for i, n in enumerate(
            n for g in osd["param_groups"] for n in g["params"])}
        osd = {"state": {index[n]: st for n, st in osd["state"].items()},
               "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                                for g in osd["param_groups"]]}
    if osd:     # `foreach` follows the placement (`tp.set_foreach`)
        osd["param_groups"] = [dict(g, foreach=None) if "foreach" in g
                               else g for g in osd["param_groups"]]
    return host_copy(msd), None if osd is None else host_copy(osd)


def load_state_dicts(model: torch.nn.Module, optimizer, model_sd: dict,
                     optim_sd: dict | None = None) -> None:
    """Load a full state (`state_dicts`' format, from any number of
    ranks) into `model` and `optimizer` as they are placed."""
    if not _placed(model):
        model.load_state_dict(model_sd)
        if optim_sd is not None:
            optimizer.load_state_dict(optim_sd)
            tp_lib.set_foreach(optimizer)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_model_state_dict)
    info = tp_lib.tp_info(model)
    if info is not None:
        _, index, size = info

        def cut(spec, x):
            return tp_lib.shard_tensor(x, spec, index, size)

        model_sd = _tp_map(model_sd, cut)
    opts = StateDictOptions(full_state_dict=True)
    if optim_sd is not None:
        # first: loading into a fresh optimizer takes a zero-gradient step
        # to create its state, which the model's load then overwrites
        _load_optimizer(model, optimizer, optim_sd, info, opts)
        tp_lib.set_foreach(optimizer)
    set_model_state_dict(model, model_sd, options=opts)


def _load_optimizer(model, optimizer, optim_sd: dict, info, opts) -> None:
    from torch.distributed.checkpoint.state_dict import \
        set_optimizer_state_dict
    if not optim_sd["state"]:        # saved before the first step
        optimizer.load_state_dict(optim_sd)
        return
    names = _param_names(model, optimizer)
    flat = [n for g in names for n in g]
    state = {flat[int(i)]: st for i, st in optim_sd["state"].items()}
    if info is not None:
        _, index, size = info
        state = _tp_map(state, lambda spec, x: tp_lib.shard_tensor(
            x, spec, index, size))
    by_name = {"state": state,
               "param_groups": [dict(g, params=n) for g, n in
                                zip(optim_sd["param_groups"], names)]}
    set_optimizer_state_dict(model, optimizer, by_name, options=opts)


def write(manager: "CheckpointManager", tree: Any) -> None:
    """Rank 0 saves `tree` into `manager`'s slot; then every rank meets at
    a barrier, so that none reads the slot before it is whole."""
    if is_primary():
        manager.save(tree)
    dist_lib.barrier()


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
