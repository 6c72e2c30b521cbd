"""The port's segmentation slice against the JAX package's, in float32 (and,
for the augmentation, bfloat16) on the CPU, from one weight set: the dense
ViT taps, the DPT decoder's seg and depth outputs, the flax-semantics
BatchNorm, the Dice loss and metrics, `fast_random_affine` at the factors
JAX draws, the rotation's plain version on the 352 px five-channel canvas
against both JAX rotations, two seg train steps with one dropout mask, the
converter, and the whole full step on the CPU. The rotation kernel itself
is checked on the card by the `gpu`-marked tests of `test_torch_kernels.py`
(this file imports flax, which the card's machine may lack).

Widths are narrow (embed 64, 2 heads, DPT features (8, 16, 32, 64), fusion
16, B = 2) at 224 px, the size whose 14 x 14 grid the port's position
embedding takes. The dense taps are held at ViT-B's depth 12 (blocks 2, 5,
8, 11); the model tests run a 4-block backbone tapped after each block,
which keeps the JAX side's compile time short."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.core.train_state import TrainState
from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.core.train_state import set_lr as jax_set_lr
from ssl4gie_tpu.core.trainer import TaskDefinition as JaxTask
from ssl4gie_tpu.core.trainer import make_train_step as jax_make_train_step
from ssl4gie_tpu.data import augment as jaug
from ssl4gie_tpu.metrics import segmentation as jseg
from ssl4gie_tpu.models.dpt import DPTDecoder as JaxDPT
from ssl4gie_tpu.models.vit import ViTBackbone as JaxViTBackbone
from ssl4gie_tpu_torch.convert.from_jax import (vit_dense_params_to_torch,
                                                vit_dense_state_dict_to_params)
from ssl4gie_tpu_torch.core.train_state import make_adamw, set_lr
from ssl4gie_tpu_torch.core.trainer import make_full_step, make_train_step
from ssl4gie_tpu_torch.data import augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.metrics import segmentation as tseg
from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.factory import ViTDenseModel
from ssl4gie_tpu_torch.models.vit import ViTBackbone
from ssl4gie_tpu_torch.tasks.segmentation import segmentation_task
from test_torch_augment import jax_classification_params
from test_torch_kernels import _jax_fold_and_factors, no_build  # noqa: F401

torch.set_num_threads(1)

B, S, DIM, HEADS = 2, 224, 64, 2
FEATURES, FUSION = (8, 16, 32, 64), 16
DEPTH, TAPS = 4, (0, 1, 2, 3)
NARROW = dict(embed_dim=DIM, num_heads=HEADS, features=FEATURES,
              fusion_features=FUSION, depth=DEPTH, dense_taps=TAPS)
LR = 1e-4            # make_adamw's default, as the JAX package's
REL = 2e-4          # f32 model outputs against JAX, relative to the largest


class JaxDense(fnn.Module):
    """The JAX package's `ViTDenseModel` at narrow widths: the same two
    submodules under the same names."""
    dense: str = "seg"

    @fnn.compact
    def __call__(self, x, train: bool = False):
        taps = JaxViTBackbone(embed_dim=DIM, num_heads=HEADS, mode="dense",
                              depth=DEPTH, dense_taps=TAPS,
                              name="backbone")(x, train)
        return JaxDPT(dense=self.dense, vit_features=DIM, features=FEATURES,
                      fusion_features=FUSION, name="decoder")(taps, train)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(dense: str):
    """The model, its params and batch_stats; depth reuses seg's backbone
    and initialises only its own decoder."""
    model = JaxDense(dense)
    key = jax.random.PRNGKey(0)
    if dense == "depth":
        params = dict(_jax_model("seg")[1])
        taps = [jnp.zeros((1, 197, DIM))] * 4
        params["decoder"] = _np_tree(JaxDPT(
            dense="depth", vit_features=DIM, features=FEATURES,
            fusion_features=FUSION).init(key, taps)["params"])
        return model, params, {}
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((1, S, S, 3)))
    return model, _np_tree(variables["params"]), \
        _np_tree(variables["batch_stats"])


def _port_model(dense: str, params, stats) -> ViTDenseModel:
    model = ViTDenseModel(dense=dense, device="cpu", **NARROW)
    model.load_state_dict(vit_dense_params_to_torch(params, stats))
    return model


def _imgs(seed=1):
    return np.random.default_rng(seed).normal(0, 1, (B, S, S, 3)).astype(
        np.float32)


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


# ----------------------------------------------------------------- models

def test_dense_taps_match_jax():
    """ViT-B's depth 12 and its four taps after blocks 2, 5, 8, 11: (B,
    1 + N, C), cls kept, no final norm (the dense backbone has no `norm`
    parameters). JAX runs op by op here: at this size that is quicker than
    compiling."""
    from ssl4gie_tpu_torch.convert.from_jax import _backbone_layers, _to_torch
    bb = JaxViTBackbone(embed_dim=DIM, num_heads=HEADS, mode="dense")
    x = _imgs()
    params = _np_tree(bb.init(jax.random.PRNGKey(3), jnp.zeros((1, S, S, 3)))
                      ["params"])
    ref = bb.apply({"params": params}, jnp.asarray(x))
    model = ViTBackbone(embed_dim=DIM, num_heads=HEADS, mode="dense")
    assert model.dense_taps == (2, 5, 8, 11)
    assert not hasattr(model, "norm")
    model.load_state_dict(_to_torch(params, _backbone_layers(12)[:-1], {
        "cls_token": torch.tensor(params["cls_token"]),
        "pos_embed": torch.tensor(params["pos_embed"])}))
    with torch.no_grad():
        taps = model(torch.from_numpy(x))
    assert len(taps) == 4
    for t, r in zip(taps, ref):
        assert t.shape == (B, 197, DIM)
        _close(t.numpy(), r)


@pytest.mark.parametrize("dense", ["seg", "depth"])
def test_dpt_outputs_match_jax(dense):
    """Eval-mode outputs (the seg logits, the depth map in [0, 1]) and, for
    seg, the train-mode forward with BatchNorm on batch statistics and the
    head's dropout given the mask that JAX drew."""
    model, params, stats = _jax_model(dense)
    x = _imgs()
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    ref = _jax_eval(model, variables, x)
    port = _port_model(dense, params, stats).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (B, S, S, 1) and out.dtype == torch.float32
    _close(out.numpy(), ref)
    if dense == "depth":
        assert 0.0 <= out.min() and out.max() <= 1.0
        return
    key = jax.random.PRNGKey(5)
    ref, keep = _jax_train_forward(model, variables, x, key)
    port.train()
    with torch.no_grad():
        out = port(torch.from_numpy(x), dropout_mask=torch.from_numpy(keep))
    _close(out.numpy(), ref)


def test_dpt_seg_at_256_px_matches_jax():
    """ViT + DPT seg at 256 px: a 16 x 16 patch grid, so the 14 x 14
    position embedding is interpolated bilinearly (JAX's
    `interpolate_pos_embed`, `models/vit.py:96-100`) and the decoder runs
    on 16 x 16 maps; eval mode, from the same weights as the 224 px
    tests."""
    model, params, stats = _jax_model("seg")
    x = np.random.default_rng(7).normal(0, 1, (B, 256, 256, 3)).astype(
        np.float32)
    ref = _jax_eval(model, {"params": params, "batch_stats": stats}, x)
    port = ViTDenseModel(dense="seg", img_size=256, device="cpu", **NARROW)
    port.load_state_dict(vit_dense_params_to_torch(params, stats))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert out.shape == (B, 256, 256, 1) and ref.shape == out.shape
    _close(out.numpy(), ref)


def _jax_eval(model, variables, x):
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False))


def _jax_train_forward(model, variables, x, key):
    """The JAX train-mode forward and its seg head's dropout keep mask (its
    output's nonzeros: where the input is 0 the mask cannot matter). The
    JAX references run op by op: at these sizes quicker than compiling."""
    out, st = model.apply(
        variables, jnp.asarray(x), train=True, rngs={"dropout": key},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    drop = st["intermediates"]["decoder"]["Dropout_0"]["__call__"][0]
    return np.asarray(out), np.asarray(drop) != 0


def test_batchnorm_matches_flax_and_not_torch():
    """Output, gradient and running statistics after two train-mode calls
    against flax `BatchNorm(momentum=0.9, epsilon=1e-5)`; torch's own
    update (unbiased variance) gives other running variances here."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(1.0, 2.0, (2, 3, 3, 4)).astype(np.float32)
          for _ in range(2)]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    scale = rng.normal(1, 0.1, 4).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": v["params"]["bias"]},
         "batch_stats": v["batch_stats"]}
    port = BatchNorm(4)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
    ref_bn = torch.nn.BatchNorm2d(4, momentum=0.1, eps=1e-5)
    for x in xs:
        def loss(p, x=x, stats=v["batch_stats"]):
            y, upd = bn.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), mutable=["batch_stats"])
            return jnp.sum(y * jnp.sin(y)), (y, upd)
        (_, (y_ref, upd)), g_ref = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        xt = torch.from_numpy(x)
        y = port(xt)
        torch.sum(y * torch.sin(y)).backward()
        ref_bn(xt.permute(0, 3, 1, 2))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port.weight.grad.numpy(),
                                   np.asarray(g_ref["scale"]), rtol=1e-4,
                                   atol=1e-5)
        port.weight.grad = None
    stats = v["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    # torch's unbiased update: var * n / (n - 1) with n = 18 per channel
    assert not np.allclose(ref_bn.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-3)


def test_conv_transpose_needs_the_flip():
    """The converter flips flax's ConvTranspose kernels (k = 4 and 2): with
    the decoder's resample kernels unflipped the port's seg logits leave the
    tolerance."""
    model, params, stats = _jax_model("seg")
    x = _imgs()
    ref = _jax_eval(model, {"params": params, "batch_stats": stats}, x)
    sd = vit_dense_params_to_torch(params, stats)
    port = ViTDenseModel(device="cpu", **NARROW).eval()
    for flip in (True, False):
        w = dict(sd)
        if not flip:
            for n in ("resample1", "resample2"):
                w[f"decoder.{n}.weight"] = sd[f"decoder.{n}.weight"].flip(2, 3)
        port.load_state_dict(w)
        with torch.no_grad():
            err = np.abs(port(torch.from_numpy(x)).numpy() - ref).max()
        assert (err <= REL * np.abs(ref).max()) == flip, (flip, err)


@pytest.mark.parametrize("dense", ["seg", "depth"])
def test_converter_round_trip(dense):
    """params and batch_stats -> state_dict -> the same trees, bit for
    bit; every parameter and BatchNorm buffer of the port is covered."""
    _, params, stats = _jax_model(dense)
    sd = vit_dense_params_to_torch(params, stats)
    port = ViTDenseModel(dense=dense, device="cpu", **NARROW)
    assert set(sd) == set(port.state_dict())
    p2, s2 = vit_dense_state_dict_to_params(sd)
    for a, b in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ----------------------------------------------------------------- metrics

def test_dice_loss_and_metrics_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (4, 16, 16, 1)).astype(np.float32)
    targets = (rng.random((4, 16, 16, 1)) > 0.6).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    lj, tj = jnp.asarray(logits), jnp.asarray(targets)
    np.testing.assert_allclose(tseg.soft_dice_loss(lt, tt).item(),
                               float(jseg.soft_dice_loss(lj, tj)), rtol=1e-6)
    for name in ("dice_score", "iou_score", "precision_score",
                 "recall_score"):
        for sig in (True, False):
            np.testing.assert_allclose(
                getattr(tseg, name)(lt, tt, apply_sigmoid=sig).item(),
                float(getattr(jseg, name)(lj, tj, apply_sigmoid=sig)),
                rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tseg.dice_per_image(lt, tt).numpy(),
                               np.asarray(jseg.dice_per_image(lj, tj)),
                               rtol=1e-6)
    for a, b in zip(tseg.dice_pair(lt, tt), jseg.dice_pair(lj, tj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------ augmentation

def jax_affine_params(key, batch: int, size: int) -> dict:
    """The factors `fast_random_affine(key, ...)` draws (its key splits and
    ranges), as the port's `sample_affine_params` dict."""
    ka, kt, ks, ksh = jax.random.split(key, 4)
    p = {"angle": jax.random.uniform(ka, (batch,), minval=-180.0,
                                     maxval=180.0),
         "translate": jax.random.uniform(kt, (batch, 2), minval=-0.125,
                                         maxval=0.125)
         * jnp.array([size, size], jnp.float32),
         "scale": jax.random.uniform(ks, (batch,), minval=0.5, maxval=1.5),
         "shear": jax.random.uniform(ksh, (batch,), minval=-22.5,
                                     maxval=22.5)}
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_random_affine_matches_jax_exactly(dtype, seed):
    """Image and mask element for element, at 224 px (the rotation on its
    352 px canvas, five channels), fed the factors JAX drew."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    mask = (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_mask = _jax_fast_affine(
        key, jnp.asarray(img).astype(dtype), jnp.asarray(mask))
    out_img, out_mask = taug.apply_affine(
        torch.from_numpy(img).to(getattr(torch, dtype)),
        torch.from_numpy(mask), jax_affine_params(key, B, S))
    assert out_img.dtype == getattr(torch, dtype)
    assert out_mask.dtype == torch.float32
    np.testing.assert_array_equal(out_img.float().numpy(),
                                  np.asarray(ref_img.astype(jnp.float32)))
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    # fill -1 outside the warped image, 0 in the mask
    assert (out_img == -1).any() and set(np.unique(out_mask.numpy())) <= {0, 1}


_jax_fast_affine = jax.jit(jaug.fast_random_affine)


def test_canvases_at_224():
    assert taug.affine_canvases(S) == (512, 352)


SEG_CANVAS = (2, 352, 352, 5)


@pytest.mark.parametrize("angles", [
    (0.0, 90.0), (180.0, -90.0),            # multiples of 90: exact turns
    (45.0, -45.0), (135.0, -135.0),         # the fold's boundary angles
    (10.0, 100.0), (-170.0, -80.0),         # quarter turns 0-3
    (33.3, 123.4)])
def test_rotation_plain_matches_both_jax_rotations(angles, no_build):
    """The plain #3 at (2, 352, 352, 5), given the shear factors JAX
    computes, against JAX's `rotate_nearest_shear` (its XLA path) and
    `shear_rotate_pallas` in interpret mode: element for element."""
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.rotate import shear_rotate_pallas

    g = np.random.default_rng(6).normal(0, 1, SEG_CANVAS).astype(np.float32)
    a = np.asarray(angles, np.float32)
    ref = np.asarray(jaug.rotate_nearest_shear(jnp.asarray(g),
                                               jnp.asarray(a)))
    folded, q, alpha, beta, P = _jax_fold_and_factors(g, a)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(shear_rotate_pallas(
            folded, jnp.asarray(alpha), jnp.asarray(beta), P, 0.0))
    np.testing.assert_array_equal(pallas, ref)
    out = rot.shear_rotate(torch.from_numpy(g), torch.from_numpy(alpha),
                           torch.from_numpy(beta), 0.0,
                           quarter=torch.from_numpy(q.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_affine_sampler_ranges():
    gen = torch.Generator().manual_seed(0)
    p = taug.sample_affine_params(4096, S, gen)
    assert p["translate"].shape == (4096, 2)
    for name, lo, hi in (("angle", -180, 180), ("scale", 0.5, 1.5),
                         ("shear", -22.5, 22.5)):
        assert lo <= p[name].min() and p[name].max() < hi, name
        assert abs(p[name].mean().item() - (lo + hi) / 2) < 0.05 * (hi - lo)
    t = p["translate"] / S
    assert -0.125 <= t.min() and t.max() < 0.125
    assert abs(t.std().item() - 0.25 / np.sqrt(12)) < 0.01
    seg = taug.sample_segmentation_params(8, S, gen)
    assert {"brightness", "order", "sigma", "hflip", "angle", "translate",
            "scale", "shear"} <= set(seg)


def jax_segmentation_params(key, batch: int, size: int) -> dict:
    """Every factor `_augment_train_batch(key, ..., mode="segmentation")`
    draws with `fast_random_affine` as its warp, as the port's dict."""
    p = jax_classification_params(key, batch)
    del p["angle"]
    p.update(jax_affine_params(jax.random.split(key, 4)[3], batch, size))
    return p


def jax_seg_augment(key, img_u8, mask):
    """The JAX package's seg branch with `fast_random_affine` (the warp it
    runs on its accelerator; its CPU takes the exact one), in f32."""
    kj, kb, kf, ka = jax.random.split(key, 4)
    img = jnp.asarray(img_u8).astype(jnp.float32) / 255.0
    img = jaug.normalize(jaug.gaussian_blur(kb, jaug.color_jitter(kj, img)))
    img, mask = jaug.random_flips(kf, img, jnp.asarray(mask))
    return _jax_fast_affine(ka, img, mask)


# ---------------------------------------------------------------- the step

def _key_bias(name, p):
    """The key slice of a qkv bias: its exact gradient is 0 (softmax ignores
    a per-row shift), so its rounding noise takes either sign."""
    if not name.endswith("attn.qkv.bias"):
        return None
    C = p.shape[0] // 3
    return slice(C, 2 * C)


class _WithMask(torch.nn.Module):
    """The port's model with its dropout mask given, as the test hands both
    packages one mask."""

    def __init__(self, model):
        super().__init__()
        self.model, self.keep = model, None

    def forward(self, x, generator=None):
        return self.model(x, generator, self.keep)


def _adam_mu(opt_state):
    """The first moment tree inside the optax chain state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return _np_tree(leaf.mu)
    raise AssertionError("no adam state found")


def test_two_seg_train_steps_match_jax():
    """The slice as a whole: a uint8 batch and its mask through both
    packages' seg augmentation (JAX's factors handed to the port: image
    1e-5, mask exactly), then two train steps on JAX's augmented batch
    (soft Dice, backward, AdamW; BatchNorm in train mode; the head's
    dropout with the mask JAX drew at each step). The first step runs at lr
    0, as a plateau scheduler can set it (so both steps start from the same
    weights; BatchNorm statistics and Adam's moments move), the second at
    LR. Each step's loss 1e-5 relative and gradients 1e-4 (relative, and of
    the largest gradient element); after two steps
    every BatchNorm running statistic within 1e-5 (with torch's unbiased
    variance update they would miss by about 1% at the 7 x 7 fusion level)
    and every parameter within 1e-5 of the largest parameter, except where
    Adam's step does not follow from the gradient: an element whose
    gradient lies within the gradients' agreement (1e-4 of the largest) at
    either step moves by about lr with a sign set by rounding
    (the key biases, whose exact gradient is 0, are all such elements);
    those are held within 2 lr, and fewer than 1 element in 10,000 lies
    beyond 1e-5 of the largest. (The
    steps take one batch for the same reason: the 1e-5 differences of the
    jitter would reach those elements.)"""
    model, params, stats = _jax_model("seg")
    rng = np.random.default_rng(7)
    img_u8 = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    mask = (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)
    akey = jax.random.PRNGKey(11)
    j_img, j_mask = jax_seg_augment(akey, img_u8, mask)
    t_img, t_mask = taug.apply_segmentation(
        torch.from_numpy(img_u8), torch.from_numpy(mask),
        jax_segmentation_params(akey, B, S))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))

    td = JaxTask(name="segmentation", aug_mode="segmentation",
                 target_key="mask", loss_fn=jseg.soft_dice_loss,
                 eval_metric_fn=None, has_dropout=True)
    state = TrainState.create(model.apply,
                              jax.tree_util.tree_map(jnp.array, params),
                              jax_make_adamw(LR),
                              jax.tree_util.tree_map(jnp.array, stats))
    step = jax_make_train_step(td, top_level=False)
    keeps, losses, grads, mu = [], [], [], None
    lrs = (0.0, LR)
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        state = state.replace(opt_state=jax_set_lr(state.opt_state, lrs[i]))
        _, keep = _jax_train_forward(
            model, {"params": state.params, "batch_stats": state.batch_stats},
            np.asarray(j_img), k)
        keeps.append(keep)
        state, m = step(state, {"image": j_img, "mask": j_mask}, k)
        losses.append(float(m["loss"]))
        # mu = b1 mu + (1 - b1) g, so each step's gradient from the moments
        new_mu = _adam_mu(state.opt_state)
        grads.append(vit_dense_params_to_torch(jax.tree_util.tree_map(
            lambda a, b: (a - 0.9 * b) / 0.1, new_mu,
            jax.tree_util.tree_map(np.zeros_like, new_mu) if mu is None
            else mu), stats))
        mu = new_mu

    port = _WithMask(_port_model("seg", params, stats))
    opt = make_adamw(port.parameters(), LR)
    tstep = make_train_step(segmentation_task())
    loose = {}                  # elements whose Adam step rounding decides
    for keep, ref_loss, ref_g, lr in zip(keeps, losses, grads, lrs):
        set_lr(opt, lr)
        port.keep = torch.from_numpy(keep)
        out = tstep(port, opt, {"image": torch.from_numpy(np.asarray(j_img)),
                                "mask": t_mask})
        np.testing.assert_allclose(out["loss"].item(), ref_loss, rtol=1e-5)
        floor = 1e-4 * max(np.abs(ref_g[n].numpy()).max()
                           for n, _ in port.model.named_parameters())
        for name, p in port.model.named_parameters():
            g, want_g = p.grad.numpy(), ref_g[name].numpy()
            np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=floor,
                                       err_msg=name)
            small = np.abs(want_g) <= floor
            loose[name] = loose.get(name, small) | small

    want = vit_dense_params_to_torch(_np_tree(state.params),
                                     _np_tree(state.batch_stats))
    largest = max(np.abs(want[n].numpy()).max()
                  for n, _ in port.model.named_parameters())
    n_far = n_all = 0
    for name, p in port.model.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        kb = _key_bias(name, p)
        if kb is not None:
            assert loose[name][kb].all(), name
        assert err[loose[name]].max(initial=0) <= 2 * LR * (1 + 1e-3), name
        assert err[~loose[name]].max(initial=0) <= 1e-5 * largest, \
            (name, err[~loose[name]].max())
        n_far += int((err > 1e-5 * largest).sum())
        n_all += p.numel()
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    n_stats = 0
    for name, v in port.model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert n_stats == 2 * (2 * 2 * 3 + 2 + 1)    # 15 BatchNorms


def test_seg_full_step_runs_on_cpu():
    """`make_full_step` with the seg task: sampling, the augmentation, the
    step with dropout from the generator, on the CPU with no kernel build
    or launch; BatchNorm statistics move, losses are finite."""
    gen = torch.Generator().manual_seed(0)
    model = ViTDenseModel(device="cpu", generator=gen, **NARROW)
    opt = make_adamw(model.parameters(), LR)
    rng = np.random.default_rng(8)
    img_u8 = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3),
                                           dtype=np.uint8))
    mask = torch.from_numpy((rng.random((B, S, S, 1)) > 0.5).astype(
        np.float32))
    before = model.decoder.head_bn.running_var.clone()
    counts = (da.attention_fwd.launches, rot.shear_rotate.launches)
    step = make_full_step(segmentation_task())
    losses = [step(model, opt, img_u8, mask, gen)["loss"].item()
              for _ in range(2)]
    assert np.all(np.isfinite(losses)) and 0 < losses[0] < 1
    assert not torch.equal(before, model.decoder.head_bn.running_var)
    assert (da.attention_fwd.launches, rot.shear_rotate.launches) == counts


def test_dropout_draws_from_the_generator():
    from ssl4gie_tpu_torch.models.dpt import dropout
    x = torch.ones((64, 64, 16))
    gen = torch.Generator().manual_seed(3)
    y = dropout(x, 0.1, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    assert torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(3)), y)
    with pytest.raises(ValueError):
        dropout(x, 0.1, None)


def test_dense_model_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViTDenseModel(**NARROW)
