"""Linear-probe recipes (port of `ssl4gie_tpu/ssl/probe.py`; MoCo v3
`main_lincls.py`, MAE `main_linprobe.py`).

Both probes train only a linear classifier on frozen features:
- MoCo v3 (`Models/moco_v3/main_lincls.py:158-166,233-237`): the head
  re-initialised to N(0, 0.01) weights and zero bias, everything else
  frozen, SGD with momentum 0.9 and no weight decay on the head;
- MAE (`Models/mae/main_linprobe.py:219-227,252`): a non-affine BatchNorm
  over the features before the head (`ViTClassifier(probe_bn=True)`,
  `head_bn`), the same head init, LARS with weight decay 0 on the head.

The freeze is `requires_grad_(False)` on every parameter but the head's,
so the backward stops at the head: no gradient flows into the backbone
and its attention backward (kernel #2) is never launched. `head_bn` owns
no parameters; its running statistics update in train mode. Both
optimizers keep their rate in the param group, so the plateau scheduler
drives it.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.core.config import SSLFramework
from ssl4gie_tpu_torch.core.train_state import freeze
from ssl4gie_tpu_torch.parallel.tp import set_foreach
from ssl4gie_tpu_torch.ssl.lars import LARS

HEAD = "lin_head"


def probe_head_trainable(name: str) -> bool:
    """Only the linear head learns."""
    return HEAD in name.split(".")


@torch.no_grad()
def reinit_head(model: torch.nn.Module, generator: torch.Generator,
                std: float = 0.01) -> None:
    """Re-initialise `lin_head` as both probe scripts do: weights N(0, std)
    drawn from `generator` on the CPU (MoCo `main_lincls.py:164-165`; MAE
    trunc-normal with the same std, `main_linprobe.py:219`), bias zero."""
    head = getattr(model, HEAD)
    w = torch.randn(head.weight.shape, generator=generator) * std
    head.weight.copy_(w)
    head.bias.zero_()


def probe_optimizer(framework: SSLFramework, params, learning_rate: float
                    ) -> torch.optim.Optimizer:
    """SGD with momentum 0.9 (MoCo v3) or LARS with weight decay 0 (MAE)."""
    if framework == SSLFramework.MOCOV3:
        return set_foreach(torch.optim.SGD(params, lr=learning_rate,
                                           momentum=0.9))
    if framework == SSLFramework.MAE:
        return LARS(params, lr=learning_rate, weight_decay=0.0, momentum=0.9)
    raise ValueError(f"no linear-probe recipe for framework {framework}")


def make_probe_optimizer(framework: SSLFramework, model: torch.nn.Module,
                         learning_rate: float) -> torch.optim.Optimizer:
    """The probe's optimizer over the head, everything else frozen."""
    return probe_optimizer(framework, freeze(model, probe_head_trainable),
                           learning_rate)
