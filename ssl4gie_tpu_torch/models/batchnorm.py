"""BatchNorm with flax semantics over channels-last tensors (port of
`flax.linen.BatchNorm` as `ssl4gie_tpu/models/resnet.py` configures it:
momentum 0.9, eps 1e-5).

It differs from `torch.nn.BatchNorm2d` in three ways that change numbers:
- the running variance is updated with the *biased* batch variance (torch
  uses the unbiased one);
- the batch variance is flax's fast form, max(0, E[x^2] - E[x]^2), taken in
  float32 whatever the compute dtype;
- the input is (..., C), channels last, as the JAX package's NHWC maps.

`momentum` is flax's: running = momentum * running + (1 - momentum) * batch
(torch's momentum 0.1). The output is (x - mean) * (rsqrt(var + eps) *
scale) + bias in float32, cast to `dtype`. When the batch is split over
ranks (`parallel/distributed.py:data_group`), the training statistics are
the global batch's, as under the JAX package's GSPMD step: the sum, the
sum of squares and the count go through one differentiable all-reduce.
Without a group they are the local means, bitwise as before.
"""

from __future__ import annotations

import torch
from torch import nn

from ssl4gie_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                    data_group)

MOMENTUM = 0.9   # flax's; torch's 0.1
EPS = 1e-5


class BatchNorm(nn.Module):
    """`affine=False`: no scale and no bias (flax's `use_scale=False,
    use_bias=False`; the last BatchNorm of MoCo v3's heads)."""

    def __init__(self, channels: int, momentum: float = MOMENTUM,
                 eps: float = EPS, dtype=torch.float32, affine: bool = True):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            dims = tuple(range(xf.ndim - 1))
            if data_group() is None:
                mean = xf.mean(dim=dims)
                mean_sq = torch.square(xf).mean(dim=dims)
            else:
                count = torch.full((1,), xf.numel() // xf.shape[-1],
                                   dtype=torch.float32, device=xf.device)
                stats = all_reduce_sum(torch.cat(
                    [xf.sum(dim=dims), torch.square(xf).sum(dim=dims),
                     count]))
                mean, mean_sq = (stats[:-1] / stats[-1]).chunk(2)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is None:
            return ((xf - mean) * mul).to(self.dtype)
        return ((xf - mean) * (mul * self.weight) + self.bias).to(self.dtype)
