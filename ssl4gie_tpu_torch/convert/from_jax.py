"""JAX param tree <-> this port's state_dict.

The inverse of `ssl4gie_tpu/convert/torch_names.py:vit_torch_to_flax` for the
classifier, and both directions for the ViT-B Faster R-CNN and the MAE
pretraining model: flax Conv
kernels (kh, kw, I, O) become torch (O, I, kh, kw); flax ConvTranspose
kernels (kh, kw, I, O) become torch (I, O, kh, kw) flipped in both spatial
axes (flax's default `transpose_kernel=False` with SAME padding at k = s = 2
gives out[2i] = w[1] x[i], out[2i+1] = w[0] x[i]; torch's conv_transpose2d
gives out[2i+a] = w[a] x[i]); Dense kernels (I, O) become Linear weights
(O, I); LayerNorm `scale` becomes `weight`. Used by the tests and by
anything that must run both packages from one weight set.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, perm=None) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    if perm is not None:
        a = a.transpose(perm)
    # a copy: the source may be read-only or (a flipped kernel) negatively
    # strided
    return torch.tensor(np.ascontiguousarray(a))


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


# ------------------------------------------------------------ Faster R-CNN

# each layer kind's leaves: (flax name, torch name)
_LEAVES = {
    "dense": (("kernel", "weight"), ("bias", "bias")),
    "conv": (("kernel", "weight"), ("bias", "bias")),
    "deconv": (("kernel", "weight"), ("bias", "bias")),
    "ln": (("scale", "weight"), ("bias", "bias")),
}


def _kernel_to_torch(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def _kernel_to_flax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "deconv":
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return a


def _backbone_layers(depth: int):
    """(flax path, torch module name, kind) of every layer of a det-mode
    ViT backbone, relative to the backbone."""
    layers = [(("patch_embed", "proj"), "patch_embed.proj", "conv")]
    for i in range(depth):
        src, dst = (f"blocks_{i}",), f"blocks.{i}"
        layers += [(src + ("norm1",), dst + ".norm1", "ln"),
                   (src + ("attn", "qkv"), dst + ".attn.qkv", "dense"),
                   (src + ("attn", "proj"), dst + ".attn.proj", "dense"),
                   (src + ("norm2",), dst + ".norm2", "ln"),
                   (src + ("mlp", "fc1"), dst + ".mlp.fc1", "dense"),
                   (src + ("mlp", "fc2"), dst + ".mlp.fc2", "dense")]
    return layers + [(("norm",), "norm", "ln")]


def _fpn_layers():
    """The same for `ViTDetFPN`, relative to the FPN."""
    layers = []
    for b in ("fpn1", "fpn2", "fpn3", "fpn4"):
        layers += [((b, "proj"), f"{b}.proj", "conv"),
                   ((b, "ln1"), f"{b}.ln1", "ln"),
                   ((b, "conv"), f"{b}.conv", "conv"),
                   ((b, "ln2"), f"{b}.ln2", "ln")]
    for d in ("fpn3_deconv", "fpn4_deconv1", "fpn4_deconv2"):
        layers.append(((d,), d, "deconv"))
    return layers + [(("fpn4_ln",), "fpn4_ln", "ln")]


def _faster_rcnn_layers(depth: int):
    """The same for the ViT-B Faster R-CNN."""
    pre = lambda fp, tp, layers: [((fp,) + p, f"{tp}.{n}", k)
                                  for p, n, k in layers]
    layers = pre("backbone", "backbone", _backbone_layers(depth))
    layers += pre("fpn", "fpn", _fpn_layers())
    for n in ("conv", "cls_logits", "bbox_pred"):
        layers.append((("rpn_head", n), f"rpn.head.{n}", "conv"))
    return layers + [
        (("box_head", "fc6"), "roi_heads.box_head.fc6", "dense"),
        (("box_head", "fc7"), "roi_heads.box_head.fc7", "dense"),
        (("box_head", "cls_score"), "roi_heads.box_predictor.cls_score",
         "dense"),
        (("box_head", "bbox_pred"), "roi_heads.box_predictor.bbox_pred",
         "dense")]


def _to_torch(tree, layers, sd=None) -> dict[str, torch.Tensor]:
    sd = {} if sd is None else sd
    for path, name, kind in layers:
        node = tree
        for p in path:
            node = node[p]
        for leaf, suffix in _LEAVES[kind]:
            a = np.asarray(node[leaf], np.float32)
            sd[f"{name}.{suffix}"] = _tensor(
                _kernel_to_torch(a, kind) if leaf == "kernel" else a)
    return sd


def _to_flax(sd, layers, tree=None) -> dict:
    tree = {} if tree is None else tree
    for path, name, kind in layers:
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        for leaf, suffix in _LEAVES[kind]:
            a = sd[f"{name}.{suffix}"]
            node[leaf] = np.ascontiguousarray(
                _kernel_to_flax(a, kind) if leaf == "kernel" else a)
    return tree


def _depth(backbone_params) -> int:
    return sum(1 for k in backbone_params if k.startswith("blocks_"))


def vit_det_backbone_params_to_torch(bb) -> dict[str, torch.Tensor]:
    """A det-mode `ViTBackbone` param tree -> the port's det-mode
    `ViTBackbone` state_dict."""
    return _to_torch(bb, _backbone_layers(_depth(bb)),
                     {"pos_embed": _tensor(bb["pos_embed"])})


def vitdet_fpn_params_to_torch(fpn) -> dict[str, torch.Tensor]:
    """A `ViTDetFPN` param tree -> the port's `ViTDetFPN` state_dict."""
    return _to_torch(fpn, _fpn_layers())


def faster_rcnn_params_to_torch(params) -> dict[str, torch.Tensor]:
    """params: the JAX `FasterRCNN(arch="vit_b")` param tree as nested dicts
    of arrays. Returns the port's `FasterRCNN` state_dict (float32 CPU
    tensors), torchvision names where the JAX tree has a counterpart."""
    return _to_torch(params, _faster_rcnn_layers(_depth(params["backbone"])),
                     {"backbone.pos_embed":
                      _tensor(params["backbone"]["pos_embed"])})


def faster_rcnn_state_dict_to_params(sd) -> dict:
    """The inverse of `faster_rcnn_params_to_torch`: a port `FasterRCNN`
    state_dict -> the JAX param tree (nested dicts of float32 numpy)."""
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    depth = sum(1 for k in sd if k.startswith("backbone.blocks.")
                and k.endswith(".norm1.weight"))
    return _to_flax(sd, _faster_rcnn_layers(depth),
                    {"backbone": {"pos_embed": sd["backbone.pos_embed"]}})


# ------------------------------------------------------------------- MAE

def _mae_layers(depth: int, decoder_depth: int):
    """(flax path, torch module name, kind) of every layer of the MAE
    model: the encoder as a ViT backbone's, then the decoder."""
    layers = _backbone_layers(depth)
    layers.append((("decoder_embed",), "decoder_embed", "dense"))
    for src, dst, kind in _backbone_layers(decoder_depth)[1:-1]:
        layers.append((("decoder_" + src[0],) + src[1:], "decoder_" + dst,
                       kind))
    return layers + [(("decoder_norm",), "decoder_norm", "ln"),
                     (("decoder_pred",), "decoder_pred", "dense")]


def mae_params_to_torch(params) -> dict[str, torch.Tensor]:
    """params: the JAX `MAE` param tree as nested dicts of arrays. Returns
    the port's `MAE` state_dict (float32 CPU tensors)."""
    decoder_depth = sum(1 for k in params if k.startswith("decoder_blocks_"))
    return _to_torch(params, _mae_layers(_depth(params), decoder_depth),
                     {"cls_token": _tensor(params["cls_token"]),
                      "mask_token": _tensor(params["mask_token"])})


def mae_state_dict_to_params(sd) -> dict:
    """The inverse of `mae_params_to_torch`: a port `MAE` state_dict -> the
    JAX param tree (nested dicts of float32 numpy)."""
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    count = lambda pre: sum(1 for k in sd if k.startswith(pre)
                            and k.endswith(".norm1.weight"))
    return _to_flax(sd, _mae_layers(count("blocks."), count("decoder_blocks.")),
                    {"cls_token": sd["cls_token"],
                     "mask_token": sd["mask_token"]})
