"""Detection task wiring (port of `ssl4gie_tpu/tasks/detection.py`):
box-aware on-device augmentation, the train step (the sum of the loss dict,
with `accum_steps` microbatch averaging) and the synthetic data source.

Static-shape data contract: every image is a fixed square canvas; GT boxes
are padded to MAX_GT with a validity mask. `DetectionSource`, `evaluate_map`
and `DetectionTrainer` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ssl4gie_tpu_torch.core.train_state import apply_gradients
from ssl4gie_tpu_torch.data.augment import (HUE, JITTER, SIGMA_RANGE,
                                            color_jitter, gaussian_blur)
from ssl4gie_tpu_torch.models.faster_rcnn import MAX_GT


class SyntheticDetectionSource:
    """Random uint8 canvases with 1-3 painted boxes each (the JAX package's
    `SyntheticDetectionSource`, same numpy draws)."""

    def __init__(self, n: int, canvas: int = 256, seed: int = 0):
        self.n, self.canvas, self.seed = n, canvas, seed

    def __len__(self):
        return self.n

    def get(self, i):
        rng = np.random.default_rng(self.seed * 7919 + i)
        img = rng.integers(0, 256, (self.canvas, self.canvas, 3), dtype=np.uint8)
        n_obj = int(rng.integers(1, 4))
        gt_boxes = np.zeros((MAX_GT, 4), np.float32)
        gt_labels = np.zeros((MAX_GT,), np.int32)
        gt_valid = np.zeros((MAX_GT,), bool)
        for j in range(n_obj):
            x0, y0 = rng.uniform(0, self.canvas * 0.6, 2)
            w, h = rng.uniform(self.canvas * 0.1, self.canvas * 0.35, 2)
            gt_boxes[j] = [x0, y0, min(x0 + w, self.canvas),
                           min(y0 + h, self.canvas)]
            gt_labels[j] = 1
            gt_valid[j] = True
            # paint the object so there is signal
            img[int(y0):int(gt_boxes[j, 3]), int(x0):int(gt_boxes[j, 2])] = \
                rng.integers(180, 256, 3)
        return {"image": img, "gt_boxes": gt_boxes, "gt_labels": gt_labels,
                "gt_valid": gt_valid}

    def batch(self, indices) -> dict:
        """The samples `indices` stacked into numpy arrays."""
        samples = [self.get(i) for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ------------------------------------------------------------ augmentation

def sample_detection_params(B: int, generator: torch.Generator) -> dict:
    """Draw every random factor of `detection_augment` on the generator's
    device, with the JAX package's ranges: jitter factors U[1-x, 1+x] (hue
    U[-h, h]) and one op order per batch, blur sigma U[0.001, 2], and the
    rot90, h-flip and v-flip flags with probability 0.5 each."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B,), generator=generator,
                                           device=dev)

    params = {name: uniform(1 - x, 1 + x) for name, x in JITTER.items()}
    params.update(
        hue=uniform(-HUE, HUE),
        order=torch.randperm(4, generator=generator, device=dev).tolist(),
        sigma=uniform(*SIGMA_RANGE))
    for flag in ("rot", "hflip", "vflip"):
        params[flag] = torch.rand((B,), generator=generator, device=dev) > 0.5
    return params


def detection_augment(img_u8: torch.Tensor, gt_boxes: torch.Tensor,
                      params: dict):
    """(B, S, S, 3) uint8 and (B, G, 4) xyxy boxes -> float32 images in
    [0, 1] and the moved boxes: color jitter and blur, then rot90 (counter-
    clockwise, `jnp.rot90(k=1, axes=(1, 2))`), h-flip and v-flip with the
    reference's box bookkeeping (`Data/dataset.py:50-80`). No normalize:
    the model normalizes. Float32 on every device, as the JAX package."""
    p = {k: v.to(img_u8.device) if torch.is_tensor(v) else v
         for k, v in params.items()}
    B, S = img_u8.shape[0], img_u8.shape[1]
    img = img_u8.to(torch.float32) / 255.0
    img = color_jitter(img, p["brightness"], p["contrast"], p["saturation"],
                       p["hue"], p["order"])
    img = gaussian_blur(img, p["sigma"])

    Sf = float(S)
    x0, y0, x1, y1 = gt_boxes.unbind(-1)
    r = p["rot"][:, None]
    img = torch.where(p["rot"].reshape(B, 1, 1, 1),
                      torch.rot90(img, 1, dims=(1, 2)), img)
    x0, y0, x1, y1 = (torch.where(r, y0, x0), torch.where(r, Sf - x1, y0),
                      torch.where(r, y1, x1), torch.where(r, Sf - x0, y1))
    h = p["hflip"][:, None]
    img = torch.where(p["hflip"].reshape(B, 1, 1, 1), img.flip(2), img)
    x0, x1 = torch.where(h, Sf - x1, x0), torch.where(h, Sf - x0, x1)
    v = p["vflip"][:, None]
    img = torch.where(p["vflip"].reshape(B, 1, 1, 1), img.flip(1), img)
    y0, y1 = torch.where(v, Sf - y1, y0), torch.where(v, Sf - y0, y1)
    return img, torch.stack([x0, y0, x1, y1], dim=-1)


# ------------------------------------------------------------ train step

def make_detection_train_step(accum_steps: int = 1):
    """Returns train_step(model, optimizer, batch, generator=None,
    noise=None) -> {"loss": total, and each loss of the dict}, averaged over
    the microbatches. `batch` holds "image", "gt_boxes", "gt_labels",
    "gt_valid" (batch on dim 0, divisible by `accum_steps`). The samplers'
    noise comes from `noise` (one dict per microbatch, as
    `FasterRCNN.draw_noise` gives) or is drawn from `generator`."""

    def train_step(model, optimizer, batch: dict,
                   generator: torch.Generator | None = None,
                   noise: list | None = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images = batch["image"]
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        mb = images.shape[0] // accum_steps
        sums = {}
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            losses = model(images[sl], batch["gt_boxes"][sl],
                           batch["gt_labels"][sl], batch["gt_valid"][sl],
                           train=True, generator=generator,
                           noise=None if noise is None else noise[i])
            total = sum(losses.values())
            total.backward()       # sums the microbatch gradients
            for k, v in {"loss": total, **losses}.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        if accum_steps > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        apply_gradients(optimizer)
        return {k: v / accum_steps for k, v in sums.items()}

    return train_step


def make_detection_full_step(accum_steps: int = 1):
    """Returns full_step(model, optimizer, batch, generator): sample the
    augmentation from `generator`, augment the uint8 batch on its device,
    then take one train step (the sampler noise from the same generator)."""
    step = make_detection_train_step(accum_steps)

    def full_step(model, optimizer, batch: dict, generator: torch.Generator):
        params = sample_detection_params(batch["image"].shape[0], generator)
        img, boxes = detection_augment(batch["image"], batch["gt_boxes"],
                                       params)
        return step(model, optimizer, dict(batch, image=img, gt_boxes=boxes),
                    generator)

    return full_step
