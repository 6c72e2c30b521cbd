"""Optimizer construction (port of `ssl4gie_tpu/core/train_state.py`).

The JAX TrainState bundles params, optimizer state and `apply_gradients`; here
the model's parameters are the float32 masters, `torch.optim.AdamW` holds the
moments, and `apply_gradients` clips (when asked) and steps.

A param group may carry an `lr_scale` (layer decay, `ssl/lr_decay.py`): its
rate is the base rate times that scale. `get_lr` reads the base rate and
`set_lr` writes the base rate times each group's scale, as the JAX
package's injected rate sits before `scale_by_layer_decay`.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

from ssl4gie_tpu_torch.parallel.tp import clip_grad_norm, set_foreach

# --frozen: parameters under these top-level names get no update and no
# decay (the JAX package's trainable predicate, `tasks/build.py:259-262`)
FROZEN_PREFIXES = ("backbone", "encoder")


def make_adamw(params: Iterable[torch.nn.Parameter],
               learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 1e-2,
               grad_clip: Optional[float] = None,
               decay_mask: Optional[Callable[[torch.Tensor], bool]] = None
               ) -> torch.optim.AdamW:
    """AdamW with decoupled weight decay, as optax.adamw in the JAX package
    and torch.optim.AdamW's defaults in the reference: on every parameter,
    or, given `decay_mask`, only on those it is true for (optax's
    `adamw(..., mask=...)`: two param groups, the second with no decay).
    `grad_clip` is a global-norm bound applied by `apply_gradients` to the
    gradients of all groups together, as optax's `clip_by_global_norm`
    before `adamw`; it is kept in each param group. `params` may be param
    groups with an `lr_scale` each (layer decay)."""
    if decay_mask is not None:
        params = list(params)
        params = [{"params": [p for p in params if decay_mask(p)]},
                  {"params": [p for p in params if not decay_mask(p)],
                   "weight_decay": 0.0}]
    opt = set_foreach(torch.optim.AdamW(params, lr=learning_rate,
                                        betas=(b1, b2), eps=eps,
                                        weight_decay=weight_decay))
    for group in opt.param_groups:
        group["grad_clip"] = grad_clip
    set_lr(opt, learning_rate)
    return opt


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    """The base learning rate (the first group's, over its `lr_scale`)."""
    group = optimizer.param_groups[0]
    return float(group.get("base_lr", group["lr"]))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the base learning rate (host-side, e.g. from a plateau
    scheduler): each param group's rate becomes `lr` times its `lr_scale`
    (1 when it has none)."""
    for group in optimizer.param_groups:
        if "lr_scale" in group:
            group["base_lr"] = lr
            group["lr"] = lr * group["lr_scale"]
        else:
            group["lr"] = lr


def apply_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Clip the gradients of every param group by one global norm to
    `grad_clip` (if set), then take one optimizer step. The norm is that
    of the whole gradients, also where a placement holds shards of them
    (FSDP over the data group, TP over the model group)."""
    bound = optimizer.param_groups[0].get("grad_clip")
    if bound is not None:
        clip_grad_norm(
            [p for group in optimizer.param_groups for p in group["params"]],
            bound)
    optimizer.step()


def freeze(model: torch.nn.Module, trainable: Callable[[str], bool]
           ) -> List[torch.nn.Parameter]:
    """The rule of `make_frozen_tx` (`ssl4gie_tpu/core/train_state.py:
    111-132`): every parameter whose name `trainable` rejects stops
    requiring a gradient; returns the others, the only ones to hand to the
    optimizer, so that frozen ones get neither an update nor weight decay
    and the global-norm clip sees only trainable gradients. BatchNorm
    running statistics are buffers, and still update in train mode."""
    kept = []
    for name, p in model.named_parameters():
        if trainable(name):
            kept.append(p)
        else:
            p.requires_grad_(False)
    return kept


def freeze_body(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """--frozen: everything under FROZEN_PREFIXES is frozen (the reference
    freezes the encoder, `Models/models.py:138-140`)."""
    return freeze(model, lambda name: not name.startswith(FROZEN_PREFIXES))
