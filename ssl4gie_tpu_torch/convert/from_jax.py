"""JAX param tree -> this port's state_dict.

The inverse of `ssl4gie_tpu/convert/torch_names.py:vit_torch_to_flax` for the
classifier: flax Conv kernels (kh, kw, I, O) become torch (O, I, kh, kw),
Dense kernels (I, O) become Linear weights (O, I), LayerNorm `scale` becomes
`weight`, and the head `lin_head` is added. Used by the tests and by anything
that must run both packages from one weight set.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, perm=None) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    if perm is not None:
        a = a.transpose(perm)
    return torch.tensor(a)      # a copy: the source may be read-only


def vit_classifier_params_to_torch(params) -> dict[str, torch.Tensor]:
    """params: the `ViTClassifier` param tree ({"backbone": ..., "lin_head":
    ...}) as nested dicts of arrays. Returns the port's `ViTClassifier`
    state_dict (float32 CPU tensors)."""
    bb = params["backbone"]
    sd = {}

    def dense(dst, src):
        sd[dst + ".weight"] = _tensor(src["kernel"], (1, 0))
        sd[dst + ".bias"] = _tensor(src["bias"])

    def norm(dst, src):
        sd[dst + ".weight"] = _tensor(src["scale"])
        sd[dst + ".bias"] = _tensor(src["bias"])

    pe = bb["patch_embed"]["proj"]
    sd["backbone.patch_embed.proj.weight"] = _tensor(pe["kernel"], (3, 2, 0, 1))
    sd["backbone.patch_embed.proj.bias"] = _tensor(pe["bias"])
    sd["backbone.cls_token"] = _tensor(bb["cls_token"])
    sd["backbone.pos_embed"] = _tensor(bb["pos_embed"])
    depth = sum(1 for k in bb if k.startswith("blocks_"))
    for i in range(depth):
        src, dst = bb[f"blocks_{i}"], f"backbone.blocks.{i}"
        norm(dst + ".norm1", src["norm1"])
        dense(dst + ".attn.qkv", src["attn"]["qkv"])
        dense(dst + ".attn.proj", src["attn"]["proj"])
        norm(dst + ".norm2", src["norm2"])
        dense(dst + ".mlp.fc1", src["mlp"]["fc1"])
        dense(dst + ".mlp.fc2", src["mlp"]["fc2"])
    for name in ("norm", "fc_norm"):
        if name in bb:
            norm(f"backbone.{name}", bb[name])
    dense("lin_head", params["lin_head"])
    return sd
