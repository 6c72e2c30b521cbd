"""The port's ViT (`ssl4gie_tpu_torch/models`) against the JAX package's, in
float32 on the CPU, from one weight set: the JAX init converted with
`vit_classifier_params_to_torch`. Small width (64, 4 heads, depth 2) at
224 px, so N = 197 and attention takes the packed-QKV path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.convert.torch_names import vit_torch_to_flax
from ssl4gie_tpu.models.layers import Block as JaxBlock
from ssl4gie_tpu.models.vit import ViTClassifier as JaxViTClassifier
from ssl4gie_tpu_torch.convert.from_jax import vit_classifier_params_to_torch
from ssl4gie_tpu_torch.models.vit import ViTBackbone, ViTClassifier

torch.set_num_threads(1)

DIM, HEADS, DEPTH, CLASSES = 64, 4, 2, 6
TOL = 2e-4       # as tests/test_convert_full_vit.py


def _jax_classifier(out_token="cls", pos_embed_type="learned", seed=0):
    model = JaxViTClassifier(num_classes=CLASSES, out_token=out_token,
                             pos_embed_type=pos_embed_type,
                             dtype=jnp.float32, depth=DEPTH, embed_dim=DIM,
                             num_heads=HEADS)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    return model, params


def _torch_classifier(params, out_token="cls", pos_embed_type="learned"):
    model = ViTClassifier(CLASSES, out_token=out_token,
                          pos_embed_type=pos_embed_type, depth=DEPTH,
                          embed_dim=DIM, num_heads=HEADS, device="cpu")
    model.load_state_dict(vit_classifier_params_to_torch(
        jax.tree_util.tree_map(np.asarray, params)))
    return model.eval()


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_block_forward_and_backward_match_jax():
    model, params = _jax_classifier()
    p0 = params["backbone"]["blocks_0"]
    x = np.random.default_rng(0).normal(0, 1, (2, 197, DIM)).astype(np.float32)

    def loss(p, x):
        o = JaxBlock(DIM, HEADS, dtype=jnp.float32).apply({"params": p}, x)
        return jnp.sum(o * jnp.sin(o)), o

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p0, jnp.asarray(x))
    blk = _torch_classifier(params).backbone.blocks[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = blk(xt)
    torch.sum(out * torch.sin(out)).backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=TOL,
                               atol=TOL)
    gp = _to_np(gp)
    pairs = {"norm1.weight": gp["norm1"]["scale"],
             "attn.qkv.weight": gp["attn"]["qkv"]["kernel"].T,
             "attn.qkv.bias": gp["attn"]["qkv"]["bias"],
             "attn.proj.weight": gp["attn"]["proj"]["kernel"].T,
             "norm2.bias": gp["norm2"]["bias"],
             "mlp.fc1.weight": gp["mlp"]["fc1"]["kernel"].T,
             "mlp.fc2.weight": gp["mlp"]["fc2"]["kernel"].T}
    grads = dict(blk.named_parameters())
    for name, ref_g in pairs.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), ref_g, rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("out_token,pos_embed_type",
                         [("cls", "learned"), ("global_pool", "sincos"),
                          ("spatial", "learned")])
def test_classifier_logits_match_jax(out_token, pos_embed_type):
    model, params = _jax_classifier(out_token, pos_embed_type)
    x = np.random.default_rng(1).normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _torch_classifier(params, out_token, pos_embed_type)(
            torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_sincos_init_matches_jax():
    _, params = _jax_classifier(pos_embed_type="sincos")
    model = ViTClassifier(CLASSES, pos_embed_type="sincos", depth=DEPTH,
                          embed_dim=DIM, num_heads=HEADS, device="cpu")
    np.testing.assert_array_equal(model.backbone.pos_embed.detach().numpy(),
                                  np.asarray(params["backbone"]["pos_embed"]))


def test_full_width_backbone_param_count():
    """timm vit_base_patch16_224 without the head (tests/test_models.py)."""
    model = ViTBackbone()
    assert sum(p.numel() for p in model.parameters()) == 85_798_656


@pytest.mark.parametrize("out_token", ["cls", "global_pool"])
def test_state_dict_round_trip(out_token):
    """JAX init -> port state_dict -> `vit_torch_to_flax` gives back the JAX
    tree; the head maps to lin_head."""
    _, params = _jax_classifier(out_token)
    sd = _torch_classifier(params, out_token).state_dict()
    back, _ = vit_torch_to_flax(
        {k[len("backbone."):]: v.numpy() for k, v in sd.items()
         if k.startswith("backbone.")}, depth=DEPTH)
    ref = _to_np(params["backbone"])
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))
    np.testing.assert_array_equal(sd["lin_head.weight"].numpy(),
                                  np.asarray(params["lin_head"]["kernel"]).T)
    np.testing.assert_array_equal(sd["lin_head.bias"].numpy(),
                                  np.asarray(params["lin_head"]["bias"]))


def test_drop_path_keeps_whole_samples_with_rescale():
    """timm DropPath semantics (the JAX package's `drop_path`): each sample
    is kept with probability 1 - rate and rescaled by 1 / (1 - rate); the
    Block asks for a generator when it needs one."""
    from ssl4gie_tpu_torch.models.layers import Block, drop_path
    out = drop_path(torch.ones(4096, 3, 2), 0.25,
                    torch.Generator().manual_seed(0)).reshape(4096, -1)
    assert bool((out == out[:, :1]).all())            # whole samples
    kept = out[:, 0] > 0
    assert bool(torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75)))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    blk = Block(DIM, HEADS, drop_path_rate=0.1)
    x = torch.zeros(1, 197, DIM)
    with pytest.raises(ValueError):
        blk.train()(x)
    blk.eval()(x)                                      # no sampling in eval


@pytest.mark.parametrize("init", ["truncated_normal", "lecun_normal"])
def test_init_std_matches_flax(init):
    """The port's timm init (`trunc_normal_`) and flax-default init
    (`lecun_normal_`) against flax's on 1000x1000 draws: standard deviations
    within 1%, and the truncated normal within +-2 std. (The timm init once
    divided by the truncated normal's own deviation, 0.8796, and came out
    14% wider than flax's.)"""
    import flax.linen as nn
    from ssl4gie_tpu_torch.models.layers import lecun_normal_, trunc_normal_
    shape, std = (1000, 1000), 0.02
    t = torch.empty(shape)
    g = torch.Generator().manual_seed(0)
    if init == "truncated_normal":
        ref = nn.initializers.truncated_normal(std)(jax.random.PRNGKey(0),
                                                    shape)
        trunc_normal_(t, std, g)
        assert t.abs().max().item() <= 2 * std * (1 + 1e-6)
        assert float(jnp.abs(ref).max()) <= 2 * std * (1 + 1e-6)
    else:
        ref = nn.initializers.lecun_normal()(jax.random.PRNGKey(0), shape)
        lecun_normal_(t, shape[0], g)
        assert abs(t.std().item() * np.sqrt(shape[0]) - 1) < 0.01
    assert abs(t.std().item() / float(jnp.std(ref)) - 1) < 0.01
    assert abs(t.mean().item()) < 0.01 * t.std().item()


def test_unported_options_raise():
    """An unknown stem raises. Dense mode at another size than 224 px
    builds and gives the interpolated grid's taps (held against JAX with
    the DPT seg head at 256 px in test_torch_segmentation.py); the conv
    stem (test_torch_moco.py), pooled sizes other than 224 px and the probe
    BatchNorm (test_torch_ingest.py, test_torch_probe_lrd.py) are
    ported."""
    dense = ViTBackbone(img_size=256, mode="dense", depth=1, embed_dim=DIM,
                        num_heads=HEADS, dense_taps=(0,))
    with torch.no_grad():
        (tap,) = dense(torch.zeros(1, 256, 256, 3))
    assert tap.shape == (1, 1 + 16 * 16, DIM)
    with pytest.raises(ValueError):
        ViTBackbone(stem="hybrid", depth=1, embed_dim=DIM, num_heads=HEADS)
    ViTBackbone(img_size=256, depth=1, embed_dim=DIM, num_heads=HEADS)
    model = ViTClassifier(CLASSES, probe_bn=True, depth=1, embed_dim=DIM,
                          num_heads=HEADS, device="cpu")
    assert not list(model.head_bn.parameters())
