"""Tensor parallelism and the placement of a model over the mesh (port of
`ssl4gie_tpu/parallel/tp.py`).

The JAX package shards the ViT's parameters by name (`TP_RULES`,
Megatron's layout) and lets GSPMD insert the collectives; it routes
attention to plain einsums under TP, since a Pallas kernel has no SPMD
rule. Here the same layout is written out, so that the attention kernel
keeps running on each rank's heads:
- `attn.qkv` is column-parallel with its (3D, D) weight viewed as
  (3, D, D): each rank keeps its heads' rows of q, of k and of v, so that
  its packed output [q_r | k_r | v_r] is what `kernels.dense_attention`
  takes at H / tp heads (a flat split of the 3D rows would mix q and k);
- `attn.proj` is row-parallel: each rank multiplies its heads' columns,
  one all-reduce over the model group sums them, and the bias is added
  once, after it;
- `mlp.fc1` column- and `mlp.fc2` row-parallel likewise;
- everything else (LayerNorms, embeddings, heads, BatchNorm) is
  replicated. The model ranks of one data index see the same batch, so
  replicated parameters get the same gradient on each of them.
The two collectives are `distributed.copy_to_model` (identity forward,
gradient sum backward, before a column-parallel layer) and
`distributed.reduce_from_model` (sum forward). A tensor-parallel
parameter is a plain tensor holding this rank's shard, so DDP and FSDP2
compose with it over the data axis unchanged.

`make_place_fn(mesh, tp, fsdp)` returns the one placement policy used at
build time: DDP over the data group, FSDP2 (`fully_shard` per block, then
the root; leaves under `FSDP_MIN_ELEMENTS` stay replicated), TP, or TP
over "model" with DDP or FSDP over "data".
"""

from __future__ import annotations

import dataclasses
import inspect
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ssl4gie_tpu_torch.core.mesh import axis_index, axis_size, make_mesh
from ssl4gie_tpu_torch.parallel import distributed as dist_lib


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """`dim` is split over the model ranks; with `groups` > 1 it is first
    viewed as `groups` contiguous parts (q, k, v), each split alike."""
    dim: int
    groups: int = 1


COLUMN, ROW, PACKED_QKV = TPSpec(0), TPSpec(1), TPSpec(0, 3)

# (name suffix, spec) of the blocks' parameters (timm names, torch's (out,
# in) weights); first match wins, every other parameter is replicated
TP_RULES: Sequence[Tuple[str, TPSpec]] = (
    ("attn.qkv.weight", PACKED_QKV),
    ("attn.qkv.bias", PACKED_QKV),
    ("attn.proj.weight", ROW),
    ("mlp.fc1.weight", COLUMN),
    ("mlp.fc1.bias", COLUMN),
    ("mlp.fc2.weight", ROW),
)
_BLOCK = re.compile(r"(^|\.)(decoder_)?blocks\.\d+\.")

# Leaves smaller than this stay replicated under FSDP (LayerNorm scales,
# biases): sharding them saves nothing and adds collectives.
FSDP_MIN_ELEMENTS = 4096


def tp_spec(name: str) -> Optional[TPSpec]:
    """The TP layout of the parameter (or optimizer state) `name`, or None
    when it is replicated: the encoder's `blocks.N.` and MAE's
    `decoder_blocks.N.` attention and MLP."""
    if not _BLOCK.search(name):
        return None
    for suffix, spec in TP_RULES:
        if name.endswith(suffix):
            return spec
    return None


def shard_tensor(x: torch.Tensor, spec: TPSpec, index: int,
                 size: int) -> torch.Tensor:
    """Model rank `index`'s part of the full tensor `x`."""
    v = x.unflatten(spec.dim, (spec.groups, -1))
    part = v.shape[spec.dim + 1] // size
    return v.narrow(spec.dim + 1, index * part, part).flatten(
        spec.dim, spec.dim + 1).contiguous()


def unshard_tensor(parts: Sequence[torch.Tensor], spec: TPSpec
                   ) -> torch.Tensor:
    """The full tensor from every model rank's part, in rank order."""
    return torch.cat([p.unflatten(spec.dim, (spec.groups, -1))
                      for p in parts], dim=spec.dim + 1).flatten(
        spec.dim, spec.dim + 1)


def make_tp_mesh(tp: int, *head_counts: int, device="cuda"):
    """The (W / tp, tp) ("data", "model") mesh, with the JAX package's
    checks: tp divides the process count and every attention head count
    it will split (a head must not straddle two ranks)."""
    n = dist_lib.process_count()
    if n % tp != 0:
        raise ValueError(f"tensor_parallel={tp} does not divide {n} devices")
    for h in head_counts:
        if h % tp != 0:
            raise ValueError(f"tensor_parallel={tp} must divide the attention "
                             f"head count {h}")
    return make_mesh((n // tp, tp), ("data", "model"), device)


def tp_info(model: nn.Module):
    """(model group, this rank's index, size) of a TP-placed model, or
    None."""
    return getattr(dist_lib.unwrap(model), "_tp", None)


def apply_tp(model: nn.Module, group, index: int, size: int) -> nn.Module:
    """Cut every block's attention and MLP parameters of `model` to model
    rank `index`'s shard (`TP_RULES`) and route their forwards through
    the model group's collectives."""
    from ssl4gie_tpu_torch.models.layers import Attention, Mlp
    for name, mod in model.named_modules():
        if not isinstance(mod, (Attention, Mlp)) or not _BLOCK.search(
                name + "."):
            continue
        if isinstance(mod, Attention):
            if mod.window_size is not None:
                raise ValueError("tensor parallelism does not split windowed "
                                 "attention (ViTDet)")
            if mod.num_heads % size:
                raise ValueError(f"tensor_parallel={size} must divide the "
                                 f"attention head count {mod.num_heads}")
        for pname, p in mod.named_parameters():
            spec = tp_spec(f"{name}.{pname}")
            if spec is not None:
                p.data = shard_tensor(p.data, spec, index, size)
                p.tp_group = group
        mod.tp_group, mod.tp_size = group, size
    model._tp = (group, index, size)
    return model


def _tag_tp(model: nn.Module) -> None:
    """Mark the (possibly FSDP-replaced) TP parameters with their group."""
    info = tp_info(model)
    if info is None:
        return
    for name, p in dist_lib.unwrap(model).named_parameters():
        if tp_spec(name) is not None:
            p.tp_group = info[0]


def shard_fsdp(model: nn.Module, mesh) -> nn.Module:
    """FSDP2 over the 1-D data mesh `mesh`: `fully_shard` on each
    transformer block and ResNet bottleneck, then on the root. Each
    parameter of at least FSDP_MIN_ELEMENTS elements is split along its
    first dimension that the data size divides; the others stay
    replicated, and `distributed.finish_gradients` averages their
    gradients."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ssl4gie_tpu_torch.models.layers import Block
    from ssl4gie_tpu_torch.models.resnet import Bottleneck
    n = mesh.size()

    def split_dim(p):
        return next((d for d, s in enumerate(p.shape) if s % n == 0), None)

    kept = [p for p in model.parameters()
            if p.numel() < FSDP_MIN_ELEMENTS or split_dim(p) is None]
    ignored = set(kept)

    def placement(p):
        return Shard(split_dim(p))

    for mod in [m for m in model.modules()
                if isinstance(m, (Block, Bottleneck))]:
        fully_shard(mod, mesh=mesh, shard_placement_fn=placement,
                    ignored_params=ignored)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement,
                ignored_params=ignored)
    model._replicated_grads = ([p for p in kept if p.requires_grad],
                               mesh.get_group())
    _tag_tp(model)
    return model


def make_place_fn(mesh, tp: bool = False, fsdp: bool = False):
    """The placement policy of a run: place(model) -> the model to train.
    No mesh (one process): the model as it is. Otherwise the data group
    becomes `distributed.data_group()`, then: TP over "model" (when
    `tp`), and over "data" FSDP2 (when `fsdp`) or DDP (skipped for a
    data axis of one under TP)."""
    def place(model: nn.Module) -> nn.Module:
        if mesh is None:
            return model
        names = mesh.mesh_dim_names
        data_mesh = mesh["data"] if len(names) > 1 else mesh
        group = data_mesh.get_group()
        dist_lib.set_data_group(group)
        if tp:
            apply_tp(model, mesh.get_group("model"),
                     axis_index(mesh, "model"), axis_size(mesh, "model"))
        if fsdp:
            return shard_fsdp(model, data_mesh)
        if tp and axis_size(mesh, "data") == 1:
            return model
        dev = next(model.parameters()).device
        ddp = nn.parallel.DistributedDataParallel
        # the BatchNorm statistics are global, so every rank's are the
        # same: no broadcast of buffers in each forward (newer torch names
        # the option `forward_sync_buffers`)
        quiet = ({"forward_sync_buffers": False} if "forward_sync_buffers"
                 in inspect.signature(ddp).parameters
                 else {"broadcast_buffers": False})
        return ddp(model, device_ids=[dev.index] if dev.type == "cuda"
                   else None, process_group=group, **quiet)
    return place


# ------------------------------------------------------------ norms

def _sharded_over(p: torch.Tensor) -> tuple:
    """The groups over which parameter `p`'s local tensor is one shard:
    FSDP's data group (a DTensor), then the model group (TP)."""
    from torch.distributed.tensor import DTensor
    groups = []
    if isinstance(p, DTensor):
        groups.append(p.device_mesh.get_group())
    tp_group = getattr(p, "tp_group", None)
    if tp_group is not None:
        groups.append(tp_group)
    return tuple(groups)


def set_foreach(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Give each param group torch's default `foreach` (None), or False
    when the optimizer's parameters mix FSDP's DTensor shards with the
    plain tensors of the leaves it leaves replicated: one multi-tensor
    kernel takes only one kind. A setting of the placement, not of the
    run: `core/checkpoint.py` saves None and sets it again on load."""
    from torch.distributed.tensor import DTensor
    kinds = {isinstance(p, DTensor) for g in optimizer.param_groups
             for p in g["params"]}
    for group in optimizer.param_groups:
        if "foreach" in group:
            group["foreach"] = False if len(kinds) > 1 else None
    return optimizer


def is_sharded(p: torch.Tensor) -> bool:
    return bool(_sharded_over(p))


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor (`t` itself otherwise)."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(pairs) -> torch.Tensor:
    """The L2 norm over (parameter, tensor) pairs of the whole tensors,
    each of whose local parts may be a shard of its parameter over the
    data or the model group (`tensor` is the parameter's gradient, or
    the parameter itself), in float32."""
    buckets = {}
    for p, t in pairs:
        key = _sharded_over(p)
        sq = local(t).to(torch.float32).square().sum()
        buckets[key] = buckets[key] + sq if key in buckets else sq
    total = None
    for groups, sq in buckets.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def grad_norm(params) -> torch.Tensor:
    """optax's global norm of the gradients of `params`: unchanged
    (`get_total_norm`) when none is sharded, else `global_norm`."""
    params = [p for p in params if p.grad is not None]
    if not any(is_sharded(p) for p in params):
        return torch.nn.utils.get_total_norm([p.grad for p in params])
    return global_norm([(p, p.grad) for p in params])


def clip_grad_norm(params, bound: float) -> None:
    """Scale the gradients of `params` by min(1, bound / (norm + 1e-6)),
    torch's `clip_grad_norm_` rule, over the whole (unsharded) gradients."""
    params = [p for p in params if p.grad is not None]
    if not any(is_sharded(p) for p in params):
        torch.nn.utils.clip_grad_norm_(params, bound)
        return
    norm = global_norm([(p, p.grad) for p in params])
    coef = torch.clamp(bound / (norm + 1e-6), max=1.0)
    grads = [local(p.grad) for p in params]
    torch._foreach_mul_(grads, coef.to(grads[0].device))

