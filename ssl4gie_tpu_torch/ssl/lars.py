"""LARS (port of `ssl4gie_tpu/ssl/lars.py`), the vendored MoCo v3 optimizer
(`Models/moco_v3/moco/optimizer.py:18-43`).

For each parameter with more than one dimension, the gradient gets the
weight decay, dp = g + wd * p, and is scaled by the trust ratio
0.001 * |p| / |dp| (1 where either norm is 0); biases and norm scales take
the bare gradient. A heavy-ball buffer mu = momentum * mu + dp gives the
update -lr * mu. `lr` is a float or a schedule, a function of LARS's own
step count, which starts at 0 and is kept in each param group ("count"),
so that it travels with `state_dict`.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


class LARS(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, dict(
            lr=0.0 if callable(lr) else float(lr), weight_decay=weight_decay,
            momentum=momentum, trust_coefficient=trust_coefficient, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS.step takes no closure")
        for group in self.param_groups:
            if self.schedule is not None:
                group["lr"] = float(self.schedule(group["count"]))
            group["count"] += 1
            lr, wd = group["lr"], group["weight_decay"]
            tc = group["trust_coefficient"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                dp = p.grad
                if p.ndim > 1:
                    dp = dp + wd * p
                    p_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(dp)
                    q = torch.where((p_norm > 0) & (u_norm > 0),
                                    tc * p_norm / u_norm,
                                    torch.ones_like(p_norm))
                    dp = dp * q
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                mu.mul_(group["momentum"]).add_(dp)
                p.add_(mu * -lr)
