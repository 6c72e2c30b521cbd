"""Process-group setup and the collectives of a multi-process run (port of
`ssl4gie_tpu/parallel/distributed.py`).

One process per GPU, launched by `torchrun` (env://), SLURM or OpenMPI.
`detect_environment` reads the launcher's variables in the reference's
order (`Models/mae/util/misc.py:216-248`) and `initialize` opens the
process group: NCCL on `cuda:LOCAL_RANK`, gloo on the CPU. A failed NCCL
init raises: nothing carries on over gloo or on one rank.

The JAX package's step is one GSPMD program over the global batch, so
every reduction that spans the batch is global. Here each rank holds its
rows of the batch (`local_rows`), and the helpers below make the same
reductions over the data-parallel group (`data_group`: the whole world,
unless a placement with a model axis set another):
- `batch_divisor`: a loss's normalizer summed over the group and divided
  by its size, so that DDP's mean of the per-rank gradients is the
  gradient of the global loss;
- `all_reduce_sum`: a differentiable sum (BatchNorm's statistics);
- `gather_rows`: the global batch of a tensor, in its order (MoCo's keys,
  mixup's partner);
- `draw_global`, `rand_global`: a sampler's draws for the global batch,
  of which each rank keeps its rows, so that W ranks draw what one
  process draws;
- `copy_to_model`, `reduce_from_model`: the two collectives of a
  tensor-parallel block (`parallel/tp.py`).
Without a process group, or with a group of one, each helper returns its
input as it is, so that one process computes bitwise what it computed
before.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

# the data-parallel group of the current placement (`set_data_group`);
# None means the whole world
_DATA_GROUP = None


def detect_environment() -> Optional[dict]:
    """The launcher's rank, world size and local rank, probed in order:
    env:// (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, as torchrun sets them),
    SLURM (`SLURM_PROCID`, `SLURM_NTASKS`, `SLURM_LOCALID`) when it runs
    more than one task, OpenMPI (`OMPI_COMM_WORLD_RANK`, `_SIZE`,
    `_LOCAL_RANK`) when it runs more than one process. None for a single
    process."""
    env = os.environ

    def count(key: str) -> int:
        return int(env.get(key) or 1)

    if "RANK" in env and "WORLD_SIZE" in env:
        found = dict(rank=int(env["RANK"]), world_size=count("WORLD_SIZE"),
                     local_rank=int(env.get("LOCAL_RANK") or 0))
    elif count("SLURM_NTASKS") > 1:
        found = dict(rank=int(env["SLURM_PROCID"]),
                     world_size=count("SLURM_NTASKS"),
                     local_rank=int(env.get("SLURM_LOCALID") or 0))
    elif count("OMPI_COMM_WORLD_SIZE") > 1:
        found = dict(rank=int(env["OMPI_COMM_WORLD_RANK"]),
                     world_size=count("OMPI_COMM_WORLD_SIZE"),
                     local_rank=int(env.get("OMPI_COMM_WORLD_LOCAL_RANK")
                                    or 0))
    else:
        return None
    return found if found["world_size"] > 1 else None


def initialize(device="cuda") -> bool:
    """Open the process group if the launcher asks for more than one
    process: NCCL with this process on `cuda:LOCAL_RANK` when `device` is
    the card, gloo on the CPU; the rendezvous is env:// (`MASTER_ADDR`,
    `MASTER_PORT`). Call it before anything touches the device. Returns
    whether the run is multi-process. This process's card becomes the
    current device, where every entry point that builds on "cuda" lands.
    """
    if is_initialized():
        return process_count() > 1
    found = detect_environment()
    if found is None:
        return False
    kwargs = dict(init_method="env://", rank=found["rank"],
                  world_size=found["world_size"])
    if torch.device(device).type == "cuda":
        local = torch.device("cuda", found["local_rank"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, or the only process: it writes the checkpoints."""
    return process_index() == 0


def barrier() -> None:
    """Every rank waits here (after rank 0's file writes)."""
    if process_count() > 1:
        dist.barrier()


def _flag_device() -> torch.device:
    """Where a collective of host values runs: the card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_flag(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (a preemption signal
    that reached one rank stops all of them at the same step)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def poll_stop(flag: bool, step: Optional[int] = None, every: int = 1) -> bool:
    """Whether to stop for a preemption signal latched in `flag`. One
    process: `flag`. Several: true on every rank when it is on any, by one
    collective (`any_flag`) at the steps that are multiples of `every` and
    at the epoch's boundaries (`step` None), where every rank polls
    alike; no collective elsewhere, so that the check adds no sync to
    every step."""
    if process_count() == 1:
        return bool(flag)
    if step is not None and step % every:
        return False
    return any_flag(flag)


# ------------------------------------------------------------ data group

def set_data_group(group) -> None:
    """Make `group` the data-parallel group (None: the whole world)."""
    global _DATA_GROUP
    _DATA_GROUP = group


def data_group():
    """The data-parallel process group, or None when the batch is not
    split (one process, or a data axis of one)."""
    if not is_initialized():
        return None
    group = _DATA_GROUP if _DATA_GROUP is not None else dist.group.WORLD
    return group if dist.get_world_size(group) > 1 else None


def data_shard() -> tuple[int, int]:
    """(this rank's index, the number of ranks) along the data axis."""
    group = data_group()
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(n_global: int, accum_steps: int = 1,
               shard: Optional[tuple[int, int]] = None) -> np.ndarray:
    """The rows of a global training batch of `n_global` that rank
    `shard` (default `data_shard()`) holds: of each of the `accum_steps`
    microbatches, its contiguous `1/n` part, as a GSPMD program shards
    every microbatch of the JAX package's scan over the data axis; with
    one microbatch, rows [i * b, (i + 1) * b)."""
    i, n = data_shard() if shard is None else shard
    if n_global % (accum_steps * n):
        raise ValueError(f"global batch {n_global} is not divisible by "
                         f"{accum_steps} microbatches x {n} ranks")
    mb = n_global // accum_steps
    part = mb // n
    return np.concatenate([np.arange(a * mb + i * part, a * mb + (i + 1) * part)
                           for a in range(accum_steps)])


def take_rows(tree, rows: np.ndarray, n_global: int):
    """`tree` (dicts, lists and tuples of tensors, arrays and plain values)
    with every tensor or array whose first dimension is `n_global` cut to
    `rows`."""
    if isinstance(tree, dict):
        return {k: take_rows(v, rows, n_global) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(v, rows, n_global) for v in tree)
    if torch.is_tensor(tree) and tree.ndim and tree.shape[0] == n_global:
        return tree[torch.as_tensor(rows, device=tree.device)]
    if isinstance(tree, np.ndarray) and tree.ndim and \
            tree.shape[0] == n_global:
        return tree[rows]
    return tree


def draw_global(sample: Callable, b_local: int, *args,
                accum_steps: int = 1, **kwargs):
    """`sample(B, *args, **kwargs)` (a sampler whose first argument is the
    batch size) drawn for the global batch, cut to this rank's rows."""
    i, n = data_shard()
    if n == 1:
        return sample(b_local, *args, **kwargs)
    n_global = b_local * n
    return take_rows(sample(n_global, *args, **kwargs),
                     local_rows(n_global, accum_steps), n_global)


def rand_global(shape, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) of `shape` on the generator's device, drawn for the global
    batch (dim 0 times the ranks) and cut to this rank's rows (a dropout
    mask, stochastic depth, MAE's masking noise)."""
    i, n = data_shard()
    shape = tuple(shape)
    if n == 1:
        return torch.rand(shape, generator=generator, device=generator.device)
    b = shape[0]
    full = torch.rand((b * n,) + shape[1:], generator=generator,
                      device=generator.device)
    return full[i * b:(i + 1) * b]


# ------------------------------------------------------------ reductions

def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data group, without gradient."""
    group = data_group()
    if group is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return total


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data group, without gradient (a logged
    loss: the mean of the per-rank losses is the global loss)."""
    group = data_group()
    if group is None:
        return x
    return global_sum(x) / dist.get_world_size(group)


def batch_divisor(den: torch.Tensor, floor=None) -> torch.Tensor:
    """The divisor of this rank's part of a loss whose normalizer `den`
    spans the batch (sum(w * nll) / sum(w), the masked sums of the depth
    loss, the RoI heads' sample count): `den` summed over the data group,
    at least `floor`, over the group's size. DDP's mean of the per-rank
    gradients is then the global loss's gradient. Without a group: `den`
    (at least `floor`)."""
    group = data_group()
    if group is None:
        return den if floor is None else torch.clamp(den, min=floor)
    total = global_sum(den)
    if floor is not None:
        total = torch.clamp(total, min=floor)
    return total / dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data group, differentiable: the backward sums
    the ranks' gradients (BatchNorm's global statistics)."""
    group = data_group()
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=group)


def gather_rows(x: torch.Tensor, accum_steps: int = 1) -> torch.Tensor:
    """The global batch of `x` (this rank holds `local_rows` of it), in
    the global order, without gradient."""
    group = data_group()
    if group is None:
        return x
    i, n = data_shard()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    out = torch.cat(parts)
    if accum_steps == 1:
        return out
    n_global = x.shape[0] * n
    order = np.concatenate([local_rows(n_global, accum_steps, (r, n))
                            for r in range(n)])
    full = torch.empty_like(out)
    full[torch.as_tensor(order, device=out.device)] = out
    return full


def gather_objects(obj) -> list:
    """Every data rank's `obj` (picklable), in rank order."""
    group = data_group()
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ------------------------------------------------------------ model parallel

def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (the output of a row-parallel
    layer); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The partial products of the model ranks summed, in float32, cast
    back to `x`'s dtype."""
    return _ReduceFromModel.apply(x, group)


# ------------------------------------------------------------ placed models

def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (the model itself otherwise)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


@contextlib.contextmanager
def gradient_sync(model: torch.nn.Module, enabled: bool):
    """Within it, the backward of a placed model reduces its gradients
    over the data group only when `enabled` (DDP's `no_sync`, FSDP2's
    `set_requires_gradient_sync`): all microbatches but the last of an
    accumulated step skip it."""
    if enabled:
        yield
    elif isinstance(model, DistributedDataParallel):
        with model.no_sync():
            yield
    elif hasattr(model, "set_requires_gradient_sync"):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


def finish_gradients(model: torch.nn.Module) -> None:
    """After the backward of a step: average over the data group the
    gradients of the parameters that an FSDP placement left replicated
    (`parallel/tp.py:FSDP_MIN_ELEMENTS`), which FSDP does not reduce."""
    params, group = getattr(unwrap(model), "_replicated_grads", ((), None))
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
        flat.split([g.numel() for g in grads]), grads)])
