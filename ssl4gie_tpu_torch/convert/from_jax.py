"""JAX param tree <-> this port's state_dict.

The inverse of `ssl4gie_tpu/convert/torch_names.py:vit_torch_to_flax` for the
classifier, and both directions for the ViT-B Faster R-CNN, the MAE
pretraining model, the ViT dense model and the four ResNet-50 models
(classifier, DeepLabV3+, depth, the RN50 Faster R-CNN; with their BatchNorm
statistics): flax
Conv kernels (kh, kw, I, O) become torch (O, I, kh, kw) (a depthwise
kernel (kh, kw, 1, C) becomes (C, 1, kh, kw) the same way); flax
ConvTranspose kernels (kh, kw, I, O) become torch (I, O, kh, kw) flipped in
both spatial axes (flax's default `transpose_kernel=False` with SAME
padding at k = s gives out[k i + a] = w[k - 1 - a] x[i]; torch's
conv_transpose2d gives out[k i + a] = w[a] x[i]); Dense kernels (I, O)
become Linear weights (O, I); LayerNorm and BatchNorm `scale` becomes
`weight`, and BatchNorm's batch_stats `mean` and `var` become
`running_mean` and `running_var`. Used by the tests and by anything that
must run both packages from one weight set.
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


def vit_classifier_state_dict_to_params(sd) -> dict:
    """The inverse of `vit_classifier_params_to_torch`: a port
    `ViTClassifier` state_dict -> its param tree, nested dicts of float32
    numpy."""
    sd = _numpy(sd)
    depth = sum(1 for k in sd if k.startswith("backbone.blocks.")
                and k.endswith(".norm1.weight"))
    norm = "fc_norm" if "backbone.fc_norm.weight" in sd else "norm"
    layers = (_prefixed("backbone", _backbone_layers(depth)[:-1]
                        + [((norm,), norm, "ln")])
              + [(("lin_head",), "lin_head", "dense")])
    return _to_flax(sd, layers, {"backbone": {
        "cls_token": sd["backbone.cls_token"],
        "pos_embed": sd["backbone.pos_embed"]}})


# ------------------------------------------------------------ Faster R-CNN

# each layer kind's leaves: (flax name, torch name)
_LEAVES = {
    "dense": (("kernel", "weight"), ("bias", "bias")),
    "conv": (("kernel", "weight"), ("bias", "bias")),
    "conv_nb": (("kernel", "weight"),),         # a conv with no bias
    "deconv": (("kernel", "weight"), ("bias", "bias")),
    "ln": (("scale", "weight"), ("bias", "bias")),
    "bn": (("scale", "weight"), ("bias", "bias")),
}
# a BatchNorm's batch_stats leaves
_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _kernel_to_torch(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind in ("conv", "conv_nb"):
        return a.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def _kernel_to_flax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind in ("conv", "conv_nb"):
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
    return layers + pre("fpn", "fpn", _fpn_layers()) + _detector_head_layers()


def _detector_head_layers():
    """The same for the RPN head and the box head of either detector."""
    layers = [(("rpn_head", n), f"rpn.head.{n}", "conv")
              for n in ("conv", "cls_logits", "bbox_pred")]
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


def _numpy(sd) -> dict:
    """float32 numpy copies of a state_dict's tensors (a view would share
    memory with the model's parameters and buffers)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


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
    sd = _numpy(sd)
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
    sd = _numpy(sd)
    count = lambda pre: sum(1 for k in sd if k.startswith(pre)
                            and k.endswith(".norm1.weight"))
    return _to_flax(sd, _mae_layers(count("blocks."), count("decoder_blocks.")),
                    {"cls_token": sd["cls_token"],
                     "mask_token": sd["mask_token"]})


# ------------------------------------------------------- ViT dense + DPT

def _dpt_layers(seg: bool):
    """(flax path, torch module name, kind) of every layer of the DPT
    decoder, relative to the decoder."""
    layers = []
    for i in range(1, 5):
        layers.append(((f"proj{i}",), f"proj{i}", "conv"))
        layers.append(((f"layer{i}_rn",), f"layer{i}_rn", "conv_nb"))
    layers += [(("resample1",), "resample1", "deconv"),
               (("resample2",), "resample2", "deconv"),
               (("resample4",), "resample4", "conv")]
    conv = "conv_nb" if seg else "conv"
    for i in (4, 3, 2, 1):
        for rcu in (("rcu2",) if i == 4 else ("rcu1", "rcu2")):
            pre = (f"refinenet{i}", rcu)
            for c in ("conv1", "conv2"):
                layers.append((pre + (c,), ".".join(pre + (c,)), conv))
            if seg:
                for b in ("bn1", "bn2"):
                    layers.append((pre + (b,), ".".join(pre + (b,)), "bn"))
        layers.append(((f"refinenet{i}", "out_conv"),
                       f"refinenet{i}.out_conv", "conv"))
    if seg:
        return layers + [(("head_conv1",), "head_conv1", "conv_nb"),
                         (("head_bn",), "head_bn", "bn"),
                         (("head_conv2",), "head_conv2", "conv")]
    return layers + [((f"head_conv{i}",), f"head_conv{i}", "conv")
                     for i in (1, 2, 3)]


def _vit_dense_layers(depth: int, seg: bool):
    """The same for `ViTDenseModel`: the dense-mode backbone (no final
    norm) under `backbone`, the decoder under `decoder`."""
    pre = lambda fp, layers: [((fp,) + p, f"{fp}.{n}", k)
                              for p, n, k in layers]
    return (pre("backbone", _backbone_layers(depth)[:-1])
            + pre("decoder", _dpt_layers(seg)))


def _stats_to_torch(batch_stats, layers, sd) -> dict[str, torch.Tensor]:
    """Add each BatchNorm's running statistics of `layers` to `sd`."""
    for path, name, kind in layers:
        if kind == "bn":
            node = batch_stats
            for p in path:
                node = node[p]
            for leaf, buf in _STATS:
                sd[f"{name}.{buf}"] = _tensor(node[leaf])
    return sd


def _stats_to_flax(sd, layers) -> dict:
    """The batch_stats tree of the BatchNorms of `layers`."""
    stats = {}
    for path, name, kind in layers:
        if kind == "bn":
            node = stats
            for p in path:
                node = node.setdefault(p, {})
            for leaf, buf in _STATS:
                node[leaf] = np.ascontiguousarray(sd[f"{name}.{buf}"])
    return stats


def vit_dense_params_to_torch(params, batch_stats) -> dict[str, torch.Tensor]:
    """params, batch_stats: the JAX `ViTDenseModel` variables as nested
    dicts of arrays (batch_stats empty for depth). Returns the port's
    `ViTDenseModel` state_dict, BatchNorm running statistics included
    (float32 CPU tensors)."""
    bb = params["backbone"]
    layers = _vit_dense_layers(_depth(bb), "head_bn" in params["decoder"])
    sd = _to_torch(params, layers,
                   {"backbone.cls_token": _tensor(bb["cls_token"]),
                    "backbone.pos_embed": _tensor(bb["pos_embed"])})
    return _stats_to_torch(batch_stats, layers, sd)


def vit_dense_state_dict_to_params(sd) -> tuple[dict, dict]:
    """The inverse of `vit_dense_params_to_torch`: a port `ViTDenseModel`
    state_dict -> (params, batch_stats), nested dicts of float32 numpy."""
    sd = _numpy(sd)
    depth = sum(1 for k in sd if k.startswith("backbone.blocks.")
                and k.endswith(".norm1.weight"))
    layers = _vit_dense_layers(depth, "decoder.head_bn.weight" in sd)
    params = _to_flax(sd, layers, {"backbone": {
        "cls_token": sd["backbone.cls_token"],
        "pos_embed": sd["backbone.pos_embed"]}})
    return params, _stats_to_flax(sd, layers)


# ------------------------------------------------------------- ResNet-50

def _resnet_layers(stage_sizes):
    """(flax path, torch module name, kind) of every layer of `ResNet50`:
    the JAX package's `layer{s}_{b}` blocks under torchvision's
    `layer{s}.{b}` names."""
    layers = [(("conv1",), "conv1", "conv_nb"), (("bn1",), "bn1", "bn")]
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            src, dst = f"layer{s + 1}_{b}", f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                layers += [((src, f"conv{i}"), f"{dst}.conv{i}", "conv_nb"),
                           ((src, f"bn{i}"), f"{dst}.bn{i}", "bn")]
            if b == 0:
                layers += [((src, "downsample_conv"), f"{dst}.downsample.0",
                            "conv_nb"),
                           ((src, "downsample_bn"), f"{dst}.downsample.1",
                            "bn")]
    return layers


def _stage_sizes_flax(encoder) -> tuple:
    return tuple(sum(1 for k in encoder if k.startswith(f"layer{s}_"))
                 for s in (1, 2, 3, 4))


def _stage_sizes_torch(sd, prefix: str) -> tuple:
    blocks = lambda pre: {k[len(pre):].split(".")[0] for k in sd
                          if k.startswith(pre)}
    return tuple(len(blocks(f"{prefix}.layer{s}.")) for s in (1, 2, 3, 4))


def _prefixed(fp: str, layers):
    return [((fp,) + p, f"{fp}.{n}", k) for p, n, k in layers]


def _resnet_classifier_layers(stage_sizes):
    return (_prefixed("backbone", _resnet_layers(stage_sizes))
            + [(("lin_head",), "lin_head", "dense")])


def _separable(fp: tuple, tp: str):
    return [(fp + (c,), f"{tp}.{c}", "conv_nb")
            for c in ("depthwise", "pointwise")]


def _deeplabv3plus_layers(stage_sizes):
    layers = _prefixed("encoder", _resnet_layers(stage_sizes))
    layers += [(("aspp", "b0_conv"), "aspp.b0_conv", "conv_nb"),
               (("aspp", "b0_bn"), "aspp.b0_bn", "bn")]
    for i in (1, 2, 3):
        layers += _separable(("aspp", f"b{i}_conv"), f"aspp.b{i}_conv")
        layers.append((("aspp", f"b{i}_bn"), f"aspp.b{i}_bn", "bn"))
    for n in ("pool", "project"):
        layers += [(("aspp", f"{n}_conv"), f"aspp.{n}_conv", "conv_nb"),
                   (("aspp", f"{n}_bn"), f"aspp.{n}_bn", "bn")]
    layers += _separable(("aspp_post",), "aspp_post")
    layers += [(("aspp_post_bn",), "aspp_post_bn", "bn"),
               (("high_conv",), "high_conv", "conv_nb"),
               (("high_bn",), "high_bn", "bn")]
    layers += _separable(("fuse_conv",), "fuse_conv")
    return layers + [(("fuse_bn",), "fuse_bn", "bn"),
                     (("seg_head",), "seg_head", "conv")]


def _resnet_depth_layers(stage_sizes):
    layers = _prefixed("encoder", _resnet_layers(stage_sizes))
    for lv in ("level0", "level1", "level2"):
        layers += [((lv, "reduce_conv"), f"{lv}.reduce_conv", "conv"),
                   ((lv, "reduce_bn"), f"{lv}.reduce_bn", "bn")]
        for i in range(3):
            blk = (lv, f"block{i}")
            names = ("id", "1", "2", "3") if i == 0 else ("1", "2", "3")
            for n in names:
                c = "id_conv" if n == "id" else f"conv{n}"
                b = "id_bn" if n == "id" else f"bn{n}"
                layers += [(blk + (c,), ".".join(blk + (c,)), "conv"),
                           (blk + (b,), ".".join(blk + (b,)), "bn")]
    return layers + [((f"out_conv{i}",), f"out_conv{i}", "conv")
                     for i in (1, 2, 3)]


def _resnet_to_torch(params, batch_stats, layers_of, top: str):
    layers = layers_of(_stage_sizes_flax(params[top]))
    return _stats_to_torch(batch_stats, layers, _to_torch(params, layers))


def _resnet_to_flax(sd, layers_of, top: str) -> tuple[dict, dict]:
    sd = _numpy(sd)
    layers = layers_of(_stage_sizes_torch(sd, top))
    return _to_flax(sd, layers), _stats_to_flax(sd, layers)


def resnet_classifier_params_to_torch(params, batch_stats
                                      ) -> dict[str, torch.Tensor]:
    """params, batch_stats: the JAX `ResNetClassifier` variables as nested
    dicts of arrays. Returns the port's `ResNetClassifier` state_dict,
    BatchNorm running statistics included (float32 CPU tensors)."""
    return _resnet_to_torch(params, batch_stats, _resnet_classifier_layers,
                            "backbone")


def resnet_classifier_state_dict_to_params(sd) -> tuple[dict, dict]:
    """The inverse of `resnet_classifier_params_to_torch`: a state_dict ->
    (params, batch_stats), nested dicts of float32 numpy."""
    return _resnet_to_flax(sd, _resnet_classifier_layers, "backbone")


def deeplabv3plus_params_to_torch(params, batch_stats
                                  ) -> dict[str, torch.Tensor]:
    """The JAX `DeepLabV3Plus` variables -> the port's `DeepLabV3Plus`
    state_dict (as `resnet_classifier_params_to_torch`)."""
    return _resnet_to_torch(params, batch_stats, _deeplabv3plus_layers,
                            "encoder")


def deeplabv3plus_state_dict_to_params(sd) -> tuple[dict, dict]:
    """The inverse of `deeplabv3plus_params_to_torch`."""
    return _resnet_to_flax(sd, _deeplabv3plus_layers, "encoder")


def resnet_depth_params_to_torch(params, batch_stats
                                 ) -> dict[str, torch.Tensor]:
    """The JAX `ResNetDepthModel` variables -> the port's
    `ResNetDepthModel` state_dict (as `resnet_classifier_params_to_torch`)."""
    return _resnet_to_torch(params, batch_stats, _resnet_depth_layers,
                            "encoder")


def resnet_depth_state_dict_to_params(sd) -> tuple[dict, dict]:
    """The inverse of `resnet_depth_params_to_torch`."""
    return _resnet_to_flax(sd, _resnet_depth_layers, "encoder")


# ------------------------------------------------ RN50 Faster R-CNN

def _faster_rcnn_rn50_layers(stage_sizes):
    """(flax path, torch module name, kind) of every layer of the RN50
    Faster R-CNN: the JAX `ResNetFPN`'s `body`, `lateral{i}` and
    `output{i}` under torchvision's `backbone.body`,
    `backbone.fpn.inner_blocks.{i}` and `backbone.fpn.layer_blocks.{i}`."""
    layers = [(("backbone", "body") + p, f"backbone.body.{n}", k)
              for p, n, k in _resnet_layers(stage_sizes)]
    for i in range(4):
        layers += [(("backbone", f"lateral{i}"),
                    f"backbone.fpn.inner_blocks.{i}", "conv"),
                   (("backbone", f"output{i}"),
                    f"backbone.fpn.layer_blocks.{i}", "conv")]
    return layers + _detector_head_layers()


def faster_rcnn_rn50_params_to_torch(params, batch_stats
                                     ) -> dict[str, torch.Tensor]:
    """params, batch_stats: the JAX `FasterRCNN(arch="resnet50")` variables
    as nested dicts of arrays. Returns the port's `FasterRCNN(arch=
    "resnet50")` state_dict, the body's BatchNorm running statistics
    included (float32 CPU tensors)."""
    layers = _faster_rcnn_rn50_layers(
        _stage_sizes_flax(params["backbone"]["body"]))
    return _stats_to_torch(batch_stats, layers, _to_torch(params, layers))


def faster_rcnn_rn50_state_dict_to_params(sd) -> tuple[dict, dict]:
    """The inverse of `faster_rcnn_rn50_params_to_torch`: a state_dict ->
    (params, batch_stats), nested dicts of float32 numpy copies."""
    sd = _numpy(sd)
    layers = _faster_rcnn_rn50_layers(_stage_sizes_torch(sd, "backbone.body"))
    return _to_flax(sd, layers), _stats_to_flax(sd, layers)
