"""What the benchmark makes from `--seed`: the weights and the traffic.

Both are made on the device from seeded generators in a few large calls,
so that the same seed gives the same numbers on the program's side and on
the reference's, and a run's set-up spends no time drawing on the host.

A traffic file (`workloads/<cell>.json`) is read by `make_traffic`, the one
generator: a pool of `pool` uint8 batches of `batch` images of `canvas` x
`canvas` x 3 pixels, cycled through the run, and, for a configuration with
classes, a label an image and one weight a class.
"""

from __future__ import annotations

import numpy as np
import torch

# the sub-streams of a seed
WEIGHTS, TRAFFIC, STEP = 0, 1, 2


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run seeded `seed` (any size)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def block_specs(prefix: str, dim: int, hidden: int) -> list:
    """(name, shape, offset) of one timm transformer block's leaves."""
    return [(f"{prefix}.norm1.weight", (dim,), 1.0),
            (f"{prefix}.norm1.bias", (dim,), 0.0),
            (f"{prefix}.attn.qkv.weight", (3 * dim, dim), 0.0),
            (f"{prefix}.attn.qkv.bias", (3 * dim,), 0.0),
            (f"{prefix}.attn.proj.weight", (dim, dim), 0.0),
            (f"{prefix}.attn.proj.bias", (dim,), 0.0),
            (f"{prefix}.norm2.weight", (dim,), 1.0),
            (f"{prefix}.norm2.bias", (dim,), 0.0),
            (f"{prefix}.mlp.fc1.weight", (hidden, dim), 0.0),
            (f"{prefix}.mlp.fc1.bias", (hidden,), 0.0),
            (f"{prefix}.mlp.fc2.weight", (dim, hidden), 0.0),
            (f"{prefix}.mlp.fc2.bias", (dim,), 0.0)]


def make_weights(specs: list, std: float, seed: int, device) -> dict:
    """float32 leaves `offset + std * N(0, 1)`, drawn as one buffer on
    `device`, every leaf a view of it."""
    total = sum(int(np.prod(shape)) for _, shape, _ in specs)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device, dtype=torch.float32).mul_(std)
    out, off = {}, 0
    for name, shape, offset in specs:
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].view(shape).add_(offset)
        off += n
    return out


def make_images(n: int, size: int, grid: int, noise: float,
                gen: torch.Generator) -> torch.Tensor:
    """(n, size, size, 3) uint8 images, each a smooth random colour field
    (a `grid` x `grid` field of U[0, 1) resized bilinearly) under its own
    level and contrast (U[0, 1) each), plus pixel noise U[-noise, noise) in
    uint8 steps: scenes that differ from image to image, as video frames of
    different organs and lighting do, rather than noise whose statistics
    every image shares."""
    dev = gen.device
    field = torch.nn.functional.interpolate(
        torch.rand((n, 3, grid, grid), generator=gen, device=dev),
        size=(size, size), mode="bilinear", align_corners=False)
    level, contrast = torch.rand((2, n, 1, 1, 1), generator=gen, device=dev)
    img = 255.0 * (level * (1 - contrast) + contrast * field)
    img = img + noise * (2 * torch.rand(img.shape, generator=gen,
                                        device=dev) - 1)
    return img.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def make_traffic(traffic: dict, num_classes: int | None, seed: int,
                 device) -> dict:
    """{"batches": [{"image": (B, S, S, 3) uint8, "label": (B,) int64}],
    "class_weights": (num_classes,) float32 U[0.5, 2)} from `seed`: `pool`
    batches of `batch` images of `canvas` pixels (`make_images` with
    `field_grid` and `pixel_noise`), a label an image and a weight a class
    when the configuration has classes."""
    gen = generator(seed, TRAFFIC, device)
    P, B, S = traffic["pool"], traffic["batch"], traffic["canvas"]
    images = make_images(P * B, S, traffic["field_grid"],
                         traffic["pixel_noise"], gen).reshape(P, B, S, S, 3)
    out = {"batches": [{"image": images[i]} for i in range(P)]}
    if num_classes:
        labels = torch.randint(0, num_classes, (P, B), generator=gen,
                               device=device)
        for i in range(P):
            out["batches"][i]["label"] = labels[i]
        out["class_weights"] = 0.5 + 1.5 * torch.rand(
            num_classes, generator=gen, device=device)
    return out
