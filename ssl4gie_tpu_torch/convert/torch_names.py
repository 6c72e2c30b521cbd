"""Reference checkpoint names -> the port's names (port of
`ssl4gie_tpu/convert/torch_names.py`).

The port's models carry timm and torchvision names, so most reference
checkpoints need no layout change, only these renames (SURVEY §5.4):
- the DDP and MoCo wrappers: `{'model': sd}` / `{'state_dict': sd}` and
  the `module.base_encoder.`, `module.` and `base_encoder.` prefixes
  (`convert_to_deit.py:24-39`);
- MoCo v3's ConvStem, an `nn.Sequential` whose indices 0/3/6/9 are the 3 x
  3 convolutions, 1/4/7/10 the BatchNorms (with running statistics) and 12
  the 1 x 1 projection (`Models/moco_v3/vits.py:75-115`), -> the port's
  `ConvStem` `conv{i}` / `bn{i}` / `proj`;
- the timm AugReg `.npz` (big_vision names, flax layouts) of the
  supervised ViT (`Models/models.py:286-290`), -> timm names in torch
  layouts;
- the torchvision ResNet-50 (supervised, Barlow Twins, MoCo RN50), whose
  names are the port's; `fc` is dropped (the reference replaces it with
  Identity, `Models/models.py:77`) and the body's coverage is checked.
The MAE decoder (`decoder_*`, `mask_token`), MoCo's projector and the heads
keep their names: they match no backbone tensor, and the loader ignores
them, as the reference's `load_my_state_dict` does.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

WRAPPERS = ("model", "state_dict")
PREFIXES = ("module.base_encoder.", "module.", "base_encoder.")
# MoCo v3 ConvStem `nn.Sequential` index -> the port's ConvStem module
CONV_STEM = {0: "conv0", 1: "bn0", 3: "conv1", 4: "bn1", 6: "conv2",
             7: "bn2", 9: "conv3", 10: "bn3", 12: "proj"}
# the encoder's tensors in a ViT checkpoint (`vit_encoder` drops the rest)
VIT_ENCODER = re.compile(r"(patch_embed|blocks|norm|fc_norm)\.|"
                         r"(cls_token|pos_embed)$")
RN50_STAGES = (3, 4, 6, 3)


def strip_prefixes(sd: dict) -> dict:
    """Unwrap {'model': sd} / {'state_dict': sd} and strip the first of
    'module.base_encoder.', 'module.', 'base_encoder.' from each key."""
    for wrapper in WRAPPERS:
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    out = {}
    for k, v in sd.items():
        for pre in PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def vit_encoder(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A timm-named ViT state dict's encoder tensors (the patch embedding,
    cls token, position embedding, blocks and final norm, `norm` or
    `fc_norm`) under the port's names: the ConvStem's
    `patch_embed.proj.{idx}.*` become `patch_embed.{conv,bn}{i}.*` and
    `patch_embed.proj.*`; its `num_batches_tracked` counters are dropped."""
    out = {}
    for k, v in sd.items():
        m = re.fullmatch(r"patch_embed\.proj\.(\d+)\.(\w+)", k)
        if m and int(m[1]) in CONV_STEM:
            k = f"patch_embed.{CONV_STEM[int(m[1])]}.{m[2]}"
        if VIT_ENCODER.match(k) and not k.endswith("num_batches_tracked"):
            out[k] = v
    return out


def _flax_kernel(a: np.ndarray) -> torch.Tensor:
    """A flax Dense (in, out) or conv (kh, kw, in, out) kernel in torch's
    layout (out, in[, kh, kw])."""
    a = np.asarray(a, np.float32)
    perm = (1, 0) if a.ndim == 2 else (3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))


def vit_from_augreg_npz(npz) -> Dict[str, torch.Tensor]:
    """A timm AugReg .npz (big_vision names) -> the ViT encoder's tensors
    under the port's names, float32 (the table of the JAX package's
    `vit_flax_from_augreg_npz`)."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd = {"patch_embed.proj.weight": _flax_kernel(npz["embedding/kernel"]),
          "patch_embed.proj.bias": f32(npz["embedding/bias"]),
          "cls_token": f32(npz["cls"]),
          "pos_embed": f32(npz["Transformer/posembed_input/pos_embedding"])}
    i = 0
    while f"Transformer/encoderblock_{i}/LayerNorm_0/scale" in npz:
        pre, blk = f"Transformer/encoderblock_{i}/", f"blocks.{i}."
        att = pre + "MultiHeadDotProductAttention_1/"
        d = npz[att + "query/kernel"].shape[0]
        qkv = np.concatenate([npz[att + a + "/kernel"].reshape(d, d)
                              for a in ("query", "key", "value")], axis=1)
        sd.update({
            blk + "norm1.weight": f32(npz[pre + "LayerNorm_0/scale"]),
            blk + "norm1.bias": f32(npz[pre + "LayerNorm_0/bias"]),
            blk + "attn.qkv.weight": _flax_kernel(qkv),
            blk + "attn.qkv.bias": f32(np.concatenate(
                [npz[att + a + "/bias"].reshape(d)
                 for a in ("query", "key", "value")])),
            blk + "attn.proj.weight": _flax_kernel(
                npz[att + "out/kernel"].reshape(d, d)),
            blk + "attn.proj.bias": f32(npz[att + "out/bias"]),
            blk + "norm2.weight": f32(npz[pre + "LayerNorm_2/scale"]),
            blk + "norm2.bias": f32(npz[pre + "LayerNorm_2/bias"]),
            blk + "mlp.fc1.weight": _flax_kernel(
                npz[pre + "MlpBlock_3/Dense_0/kernel"]),
            blk + "mlp.fc1.bias": f32(npz[pre + "MlpBlock_3/Dense_0/bias"]),
            blk + "mlp.fc2.weight": _flax_kernel(
                npz[pre + "MlpBlock_3/Dense_1/kernel"]),
            blk + "mlp.fc2.bias": f32(npz[pre + "MlpBlock_3/Dense_1/bias"])})
        i += 1
    sd["norm.weight"] = f32(npz["Transformer/encoder_norm/scale"])
    sd["norm.bias"] = f32(npz["Transformer/encoder_norm/bias"])
    return sd


def resnet_names(stage_sizes=RN50_STAGES) -> list[str]:
    """The torchvision names of a ResNet-50 body's tensors (the port's):
    the stem, each bottleneck's three convolutions and BatchNorms (weight,
    bias, running statistics) and the first block's downsample."""
    bn = lambda m: [f"{m}.{leaf}" for leaf in ("weight", "bias",
                                               "running_mean", "running_var")]
    names = ["conv1.weight", *bn("bn1")]
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            for c in (1, 2, 3):
                names += [f"{pre}.conv{c}.weight", *bn(f"{pre}.bn{c}")]
            if b == 0:
                names += [f"{pre}.downsample.0.weight",
                          *bn(f"{pre}.downsample.1")]
    return names


def resnet_encoder(sd: Dict[str, torch.Tensor],
                   stage_sizes=RN50_STAGES) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-50 state dict's body tensors; raises KeyError
    naming what a full body needs and the checkpoint lacks (as the JAX
    package's `resnet_torch_to_flax` does). `fc` and the BatchNorms'
    `num_batches_tracked` are dropped."""
    names = resnet_names(stage_sizes)
    missing = [k for k in names if k not in sd]
    if missing:
        raise KeyError(f"ResNet-50 checkpoint lacks {len(missing)} body "
                       f"tensors, e.g. {missing[:3]}")
    return {k: sd[k] for k in names}
