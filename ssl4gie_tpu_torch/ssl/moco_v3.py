"""MoCo v3 pretraining (port of `ssl4gie_tpu/ssl/moco_v3.py`).

A base encoder (ViT with fixed-init sin-cos position embedding and the cls
token, or ResNet-50 pooled, plus a projector MLP: 3 layers for ViT, 2 for
RN50), a predictor MLP (2 layers), and a momentum encoder, the EMA of the
base encoder's parameters (`Models/moco_v3/moco/builder.py:57-61`); the
symmetric InfoNCE loss `contrastive_loss` (`builder.py:63-73`).

When the batch is split over ranks the loss is the global batch's, as the
JAX package's GSPMD einsum computes it: each rank's queries against the
keys gathered from every rank, with rank-offset labels (the reference's
`concat_all_gather`, `builder.py:63-73`), and the heads' BatchNorm takes
global statistics (`models/batchnorm.py`).

`MoCo` holds the three modules, so that one `state_dict` carries the
parameters of the encoder and the predictor, the momentum parameters and
both sets of BatchNorm statistics. The backbone keeps the finetune models'
names (`encoder.backbone.*`), so an exported encoder loads into
`ViTClassifier` or `ResNetClassifier` by its `backbone.` prefix.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.core.spans import span
from ssl4gie_tpu_torch.core.train_state import set_lr
from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.layers import default_device, lecun_normal_
from ssl4gie_tpu_torch.models.resnet import STAGE_SIZES, WIDTHS, ResNet50
from ssl4gie_tpu_torch.models.vit import ViTBackbone
from ssl4gie_tpu_torch.parallel.distributed import (data_shard,
                                                    finish_gradients,
                                                    gather_rows, global_mean,
                                                    unwrap)
from ssl4gie_tpu_torch.parallel.tp import grad_norm as global_grad_norm
from ssl4gie_tpu_torch.parallel.tp import local

# MoCo v3 ViT size presets (`Models/moco_v3/vits.py:117-144`): the conv-stem
# variants drop one transformer block; vit_s keeps 12 heads at width 384
# (head width 32)
VIT_PRESETS = {
    "vit_b":      dict(embed_dim=768, depth=12, num_heads=12, stem="patch"),
    "vit_s":      dict(embed_dim=384, depth=12, num_heads=12, stem="patch"),
    "vit_conv_s": dict(embed_dim=384, depth=11, num_heads=12, stem="conv"),
    "vit_conv_b": dict(embed_dim=768, depth=11, num_heads=12, stem="conv"),
}
# MoCo v3's --stop-grad-conv1 applies to the patch-projection ViTs only
# (`vits.py:43-51` guards on `isinstance(self.patch_embed, PatchEmbed)`)
STOP_GRAD_ARCHS = ("vit_b", "vit_s")


class MLPHead(nn.Module):
    """`_build_mlp` (`builder.py:36-52`): Linear layers without bias
    (`fc{l}`), each hidden one followed by BatchNorm (`bn{l}`) and ReLU,
    the last by an affine-free BatchNorm (`last_bn`). Runs in `dtype`;
    flax's default init (lecun normal)."""

    def __init__(self, in_dim: int, num_layers: int, mlp_dim: int,
                 out_dim: int, last_bn: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_layers, self.last_bn, self.dtype = num_layers, last_bn, dtype
        d1 = in_dim
        for l in range(num_layers):
            last = l == num_layers - 1
            d2 = out_dim if last else mlp_dim
            self.add_module(f"fc{l}", nn.Linear(d1, d2, bias=False))
            if not last or last_bn:
                self.add_module(f"bn{l}", BatchNorm(d2, dtype=dtype,
                                                    affine=not last))
            d1 = d2

    def reset_parameters(self, generator: torch.Generator) -> None:
        for l in range(self.num_layers):
            fc = getattr(self, f"fc{l}")
            lecun_normal_(fc.weight, fc.in_features, generator)
            if hasattr(self, f"bn{l}"):
                getattr(self, f"bn{l}").reset_parameters()

    def forward(self, x):
        for l in range(self.num_layers):
            x = F.linear(x.to(self.dtype),
                         getattr(self, f"fc{l}").weight.to(self.dtype))
            if hasattr(self, f"bn{l}"):
                x = getattr(self, f"bn{l}")(x)
            if l < self.num_layers - 1:
                x = F.relu(x)
        return x


class MoCoPredictor(MLPHead):
    """The 2-layer predictor, `dim` -> `mlp_dim` -> `dim`."""

    def __init__(self, dim: int = 256, mlp_dim: int = 4096,
                 dtype=torch.float32):
        super().__init__(dim, 2, mlp_dim, dim, last_bn=True, dtype=dtype)


class MoCoEncoder(nn.Module):
    """`backbone` (a ViT of VIT_PRESETS, cls token, sin-cos position
    embedding, or ResNet-50 pooled) + `projector`."""

    def __init__(self, arch: str = "vit_b", dim: int = 256,
                 mlp_dim: int = 4096, dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__()
        self.dtype = dtype
        if arch in VIT_PRESETS:
            preset = VIT_PRESETS[arch]
            self.backbone = ViTBackbone(mode="pooled", out_token="cls",
                                        pos_embed_type="sincos", dtype=dtype,
                                        **preset)
            self.projector = MLPHead(preset["embed_dim"], 3, mlp_dim, dim,
                                     dtype=dtype)
        elif arch == "resnet50":
            self.backbone = ResNet50(mode="pooled", dtype=dtype,
                                     stage_sizes=stage_sizes)
            self.projector = MLPHead(4 * WIDTHS[-1], 2, mlp_dim, dim,
                                     dtype=dtype)
        else:
            raise ValueError(f"arch {arch!r} not in {list(VIT_PRESETS)} + "
                             "['resnet50']")

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.projector.reset_parameters(generator)

    def forward(self, x):
        """x: (B, S, S, 3) NHWC -> (B, dim) in `dtype`."""
        return self.projector(self.backbone(x).to(self.dtype))


class MoCo(nn.Module):
    """`encoder`, `predictor` and `momentum_encoder` (a copy of the encoder
    at construction; its parameters take no gradient). Weights are drawn
    from `generator` on the CPU (seed 0 when none is given), then moved to
    `device`: the card when none is given (no card raises; `device="cpu"`
    builds on the CPU). `stage_sizes` narrows the RN50 (tests)."""

    def __init__(self, arch: str = "vit_b", dim: int = 256,
                 mlp_dim: int = 4096, dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = default_device(device)
        self.arch = arch
        self.encoder = MoCoEncoder(arch, dim, mlp_dim, dtype, stage_sizes)
        self.predictor = MoCoPredictor(dim, mlp_dim, dtype)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.encoder.reset_parameters(gen)
        self.predictor.reset_parameters(gen)
        self.momentum_encoder = copy.deepcopy(self.encoder)
        self.momentum_encoder.requires_grad_(False)
        self.to(device)

    def trained_parameters(self) -> list:
        """The encoder's and the predictor's parameters (what the optimizer
        steps and the gradient norm counts)."""
        return [*self.encoder.parameters(), *self.predictor.parameters()]

    def patch_embed_parameters(self) -> list:
        """The base encoder's patch projection (--stop-grad-conv1)."""
        return list(self.encoder.backbone.patch_embed.parameters())

    def forward(self, x1, x2):
        """One step's forwards, in the JAX step's order: the momentum
        encoder without gradient on x1 then x2 (keys k1, k2), then the
        encoder and the predictor on x1 then on x2 (pq1, pq2). Returns (pq1,
        pq2, k1, k2)."""
        with torch.no_grad():
            k1 = self.momentum_encoder(x1)
            k2 = self.momentum_encoder(x2)
        pq1 = self.predictor(self.encoder(x1))
        pq2 = self.predictor(self.encoder(x2))
        return pq1, pq2, k1, k2


def contrastive_loss(q: torch.Tensor, k: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """InfoNCE of queries q against keys k (N, C) with the positives on the
    diagonal (`builder.py:63-73`): rows L2-normalised as x / (|x| +
    1e-12) in their dtype, logits in float32 over `temperature`,
    cross-entropy against arange(N), times 2 * temperature. When the batch
    is split over ranks, this rank's queries go against the keys of the
    global batch (gathered without gradient: they come from the momentum
    encoder), its positives offset by its rank."""
    q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    k = k / (torch.linalg.vector_norm(k, dim=1, keepdim=True) + 1e-12)
    logits = (q.float() @ gather_rows(k).float().t()) / temperature
    rank, _ = data_shard()
    labels = torch.arange(q.shape[0], device=logits.device) + \
        rank * q.shape[0]
    return F.cross_entropy(logits, labels) * (2.0 * temperature)


@torch.no_grad()
def momentum_update(moco: MoCo, m: float) -> None:
    """momentum = m * momentum + (1 - m) * encoder over the parameters
    (never the BatchNorm statistics), as `lerp` toward the encoder with
    weight 1 - m, taken in float32 as the JAX package's float32 `m`. A
    parameter equal in both (the frozen patch projection) stays bitwise
    equal."""
    m32 = np.float32(m)
    torch._foreach_lerp_(list(moco.momentum_encoder.parameters()),
                         list(moco.encoder.parameters()),
                         float(np.float32(1.0) - m32))


def make_moco_train_step(temperature: float = 0.2, schedule=None,
                         stop_grad_patch_embed: bool = False):
    """Returns train_step(moco, optimizer, x1, x2, m, step) -> {"loss",
    "grad_norm"}, in the JAX step's order (`moco_v3.py:147-182`):
    1. the EMA of the encoder's parameters with momentum m;
    2. the momentum encoder in train mode, without gradient, on x1 then x2
       (its BatchNorm statistics updated in that order);
    3. the encoder on x1 then x2, the predictor on q1 then q2;
    4. loss = L(pq1, k2) + L(pq2, k1), its backward, the global norm of
       every gradient (the frozen patch projection's included, as the JAX
       package reports it), and one optimizer step at `schedule(step)` when
       a schedule is given (an optimizer that keeps its own schedule, as
       `LARS` does, takes None).
    With `stop_grad_patch_embed` the patch projection's update is zero (the
    JAX package's `optax.masked(set_to_zero())` after the optimizer): its
    gradient is computed and the optimizer's state sees it, but its
    weights are put back after the step."""

    def train_step(moco: MoCo, optimizer, x1, x2, m: float, step: int):
        inner = unwrap(moco)      # `moco` may be placed (DDP, FSDP, TP)
        moco.train()
        with span("ssl4gie.optimizer"):
            momentum_update(inner, m)
        with span("ssl4gie.forward"):
            pq1, pq2, k1, k2 = moco(x1, x2)
            loss = (contrastive_loss(pq1, k2, temperature)
                    + contrastive_loss(pq2, k1, temperature))
        optimizer.zero_grad(set_to_none=True)
        with span("ssl4gie.backward"):
            loss.backward()
            finish_gradients(moco)
        with span("ssl4gie.optimizer"):
            grad_norm = global_grad_norm(inner.trained_parameters())
            if schedule is not None:
                set_lr(optimizer, schedule(step))
            frozen = [local(p) for p in inner.patch_embed_parameters()] \
                if stop_grad_patch_embed else []
            kept = [p.detach().clone() for p in frozen]
            optimizer.step()
            if frozen:
                with torch.no_grad():
                    torch._foreach_copy_(frozen, kept)
        return {"loss": global_mean(loss.detach()), "grad_norm": grad_norm}

    return train_step
