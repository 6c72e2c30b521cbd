"""Optimizer construction (port of `ssl4gie_tpu/core/train_state.py`).

The JAX TrainState bundles params, optimizer state and `apply_gradients`; here
the model's parameters are the float32 masters, `torch.optim.AdamW` holds the
moments, and `apply_gradients` clips (when asked) and steps.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch


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
    before `adamw`; it is kept in each param group."""
    if decay_mask is not None:
        params = list(params)
        params = [{"params": [p for p in params if decay_mask(p)]},
                  {"params": [p for p in params if not decay_mask(p)],
                   "weight_decay": 0.0}]
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
    for group in opt.param_groups:
        group["grad_clip"] = grad_clip
    return opt


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group (host-side, e.g. from a
    plateau scheduler)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def apply_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Clip the gradients of every param group by one global norm to
    `grad_clip` (if set), then take one optimizer step."""
    bound = optimizer.param_groups[0].get("grad_clip")
    if bound is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for group in optimizer.param_groups for p in group["params"]],
            bound)
    optimizer.step()
