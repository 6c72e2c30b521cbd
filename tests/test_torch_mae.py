"""The port's MAE pretraining slice (`ssl4gie_tpu_torch/ssl`,
`ssl4gie_tpu_torch/data/ssl_augment.py`) against the JAX package's, in
float32 on the CPU, from one weight set and the same masking noise (the
JAX model's key passed through `MAE.__call__(rng=...)` and its draw
`jax.random.uniform(key, (B, L))` handed to the port): patchify, masking,
the model's loss, prediction and gradients, two optimizer steps on the
warmup-cosine schedule, the schedule, the augmentation at the JAX draws,
the init, and the entry points' device default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.ssl import mae as jmae
from ssl4gie_tpu.ssl import pretrain as jpre
from ssl4gie_tpu_torch.convert.from_jax import (mae_params_to_torch,
                                                mae_state_dict_to_params)
from ssl4gie_tpu_torch.core.config import PretrainConfig
from ssl4gie_tpu_torch.data import ssl_augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import fused_mlp as fm
from ssl4gie_tpu_torch.ssl import mae as tmae
from ssl4gie_tpu_torch.ssl import pretrain as tpre

torch.set_num_threads(1)

B = 2
# img 64: L = 16, every attention plain; img 224: L = 196, the decoder's
# 197 tokens at Dh = 32 take the packed-QKV route (its plain version here)
SMALL = {64: dict(img_size=64, patch_size=16, embed_dim=64, depth=2,
                  num_heads=4, decoder_embed_dim=32, decoder_depth=2,
                  decoder_num_heads=2),
         224: dict(img_size=224, patch_size=16, embed_dim=64, depth=2,
                   num_heads=4, decoder_embed_dim=64, decoder_depth=2,
                   decoder_num_heads=2)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mae(size, seed=0):
    kw = SMALL[size]
    model = jmae.MAE(dtype=jnp.float32, **kw)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "mask": key},
                        jnp.zeros((1, size, size, 3), jnp.float32))["params"]
    return model, _np_tree(params)


def _port_mae(size, params):
    model = tmae.MAE(device="cpu", **SMALL[size])
    model.load_state_dict(mae_params_to_torch(params))
    return model


def _imgs(size, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (B, size, size, 3)).astype(np.float32)


def test_patchify_and_unpatchify_are_exact():
    x = _imgs(64)
    p = tmae.patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jmae.patchify(x)))
    np.testing.assert_array_equal(tmae.unpatchify(p).numpy(), x)
    np.testing.assert_array_equal(
        tmae.unpatchify(p).numpy(),
        np.asarray(jmae.unpatchify(jnp.asarray(p.numpy()))))


@pytest.mark.parametrize("mask_ratio", [0.75, 0.5])
def test_random_masking_matches_jax_exactly(mask_ratio):
    """At noise = jax.random.uniform(key, (B, L)): the kept tokens, the mask
    and ids_restore are exactly the JAX ones."""
    L, D = 196, 8
    x = np.random.default_rng(2).normal(0, 1, (B, L, D)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    xm, mask, ids = jmae.random_masking(key, jnp.asarray(x), mask_ratio)
    noise = np.array(jax.random.uniform(key, (B, L)))
    txm, tmask, tids = tmae.random_masking(torch.from_numpy(x), mask_ratio,
                                           torch.from_numpy(noise))
    np.testing.assert_array_equal(txm.numpy(), np.asarray(xm))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))


@pytest.mark.parametrize("size", [64, 224])
def test_mae_loss_pred_and_gradients_match_jax(size):
    """f32: loss within 1e-5 relative, pred within 2e-4, every gradient
    within 1e-4 of its tensor's largest element; the mask exactly."""
    model, params = _jax_mae(size)
    x = _imgs(size)
    key = jax.random.PRNGKey(5)
    L = (size // 16) ** 2

    def loss_fn(p):
        loss, pred, mask = model.apply({"params": p}, jnp.asarray(x),
                                       rng=key)
        return loss, (pred, mask)

    (loss, (pred, mask)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tmodel = _port_mae(size, params)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (B, L))))
    tloss, tpred, tmask = tmodel(torch.from_numpy(x), noise)
    tloss.backward()

    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(pred),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    ref = mae_params_to_torch(_np_tree(grads))
    named = dict(tmodel.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        r = ref[name].numpy()
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err, np.abs(r).max())


def _key_bias(name, p):
    """The key slice of a qkv bias: its exact gradient is 0 (softmax ignores
    a per-row shift), so its rounding noise takes either sign."""
    if not name.endswith("attn.qkv.bias"):
        return None
    C = p.shape[0] // 3
    return slice(C, 2 * C)


def test_two_optimizer_steps_match_optax():
    """Two full steps (loss, backward, AdamW with betas (0.9, 0.95), wd 0.05
    on ndim > 1, the warmup-cosine learning rate) against the JAX step with
    optax `adamw(..., mask=wd_mask)`, one noise draw per step. The first
    step runs at lr 0 (parameters unchanged); after the second every
    parameter is within 1e-5 of the largest, the key biases (see
    `_key_bias`) within 2 lr."""
    import optax
    size, warmup, total, peak = 64, 2, 10, 1e-3
    model, params = _jax_mae(size)
    x = jnp.asarray(_imgs(size))
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    schedule = jpre.make_schedule(peak, warmup, total)
    tx = optax.adamw(schedule, b1=0.9, b2=0.95, weight_decay=0.05,
                     mask=jpre.wd_mask(params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    ref = []
    for k in keys:
        loss, g = jax.value_and_grad(lambda p: model.apply(
            {"params": p}, x, rng=k)[0])(jp)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ref.append((float(loss), float(optax.global_norm(g))))

    tmodel = _port_mae(size, params)
    p0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    cfg = PretrainConfig(weight_decay=0.05)
    opt = tpre.make_mae_optimizer(tmodel, cfg)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]
    assert all(p.ndim > 1 for p in opt.param_groups[0]["params"])
    step = tpre.make_mae_train_step(tpre.make_schedule(peak, warmup, total))
    for i, k in enumerate(keys):
        noise = torch.from_numpy(np.asarray(jax.random.uniform(
            k, (B, (size // 16) ** 2))))
        out = step(tmodel, opt, torch.from_numpy(np.asarray(x)), noise, i)
        np.testing.assert_allclose(out["loss"].item(), ref[i][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"].item(), ref[i][1],
                                   rtol=1e-5)
        if i == 0:
            for name, v in tmodel.state_dict().items():
                assert torch.equal(v, p0[name]), name
    want = mae_params_to_torch(_np_tree(jp))
    largest = max(np.abs(v.numpy()).max() for v in want.values())
    lr = schedule(1)
    for name, p in tmodel.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        kb = _key_bias(name, p)
        if kb is not None:
            assert err[kb].max() <= 2 * lr * (1 + 1e-3), name
            err[kb] = 0
        assert err.max() <= 1e-5 * largest, (name, err.max())


@pytest.mark.parametrize("warmup,total", [(0, 10), (5, 20), (400, 4000)])
def test_schedule_matches_optax(warmup, total):
    """Step 0 (lr 0), the end of the warmup, midway through the decay, the
    end and past it."""
    peak = 1.5e-4 * 64 / 256
    ref = jpre.make_schedule(peak, warmup, total)
    ours = tpre.make_schedule(peak, warmup, total)
    w = max(warmup, 1)
    for step in (0, w // 2, w, (w + total) // 2, total - 1, total,
                 total + 7):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))
    assert ours(0) == 0.0


def test_pretrain_config_defaults_and_lr_scaling():
    """The MAE defaults of the JAX `PretrainConfig` and `base_lr * B / 256`."""
    from ssl4gie_tpu.core.config import PretrainConfig as JaxPretrainConfig
    ref = JaxPretrainConfig()
    cfg = PretrainConfig()
    for f in ("base_lr", "weight_decay", "batch_size", "img_size",
              "mask_ratio", "norm_pix_loss"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.effective_lr() == pytest.approx(
        ref.base_lr * ref.batch_size / 256.0)


def test_synthetic_unlabeled_matches_jax():
    src = jpre.SyntheticUnlabeled(5, canvas=32, seed=3)
    ours = tpre.SyntheticUnlabeled(5, canvas=32, seed=3)
    assert len(ours) == len(src)
    batch = ours.batch(range(5))["image"]
    for i in range(5):
        np.testing.assert_array_equal(batch[i], src.get(i)["image"])


def _jax_mae_draws(key, batch, canvas):
    """The crop boxes and flips `mae_augment(key, ...)` draws op by op (see
    `test_mae_augment_matches_jax`), replaying its key splits and box
    arithmetic (`mae_augment`, `random_resized_crop`). The port's
    `crop_boxes` of the same unit draws is held to them within 2 float32
    ulps (XLA's and torch's exp may round apart; at source coordinates
    near 255 one ulp is 1.5e-5 of a pixel, so the images take the JAX
    boxes)."""
    with jax.disable_jit():
        kc, kf = jax.random.split(key)
        ka, kr, kx, ky = jax.random.split(kc, 4)
        area_frac = jax.random.uniform(ka, (batch,), minval=0.2, maxval=1.0)
        log_r = jax.random.uniform(kr, (batch,), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3))
        ux = jax.random.uniform(kx, (batch,))
        uy = jax.random.uniform(ky, (batch,))
        area = area_frac * (canvas * canvas)
        r = jnp.exp(log_r)
        w = jnp.clip(jnp.sqrt(area * r), 1.0, canvas)
        h = jnp.clip(jnp.sqrt(area / r), 1.0, canvas)
        box = jnp.stack([ux * (canvas - w), uy * (canvas - h), w, h], axis=1)
        flip = jax.random.uniform(kf, (batch, 1, 1, 1)) > 0.5
    t = lambda a: torch.from_numpy(np.array(a))
    ours = taug.crop_boxes(t(area_frac), t(log_r), t(ux), t(uy), canvas,
                           canvas)
    np.testing.assert_allclose(ours.numpy(), np.asarray(box), rtol=2.5e-7)
    return {"box": t(box), "flip": t(flip).reshape(batch)}


@pytest.mark.parametrize("seed", [0, 1])
def test_mae_augment_matches_jax(seed):
    """`mae_augment` at the crop boxes and flips the JAX one drew from the
    same key (f32, 256 px canvas to 224): within 1e-5. The JAX function
    runs op by op: jitted, XLA's CPU program puts its interpolation
    products up to 3.9e-5 (of [0, 1] pixels) off the exact two-tap values,
    which the op-by-op run and the port both give (7e-7 apart)."""
    from ssl4gie_tpu.data.ssl_augment import mae_augment
    img = np.random.default_rng(seed).integers(0, 256, (4, 256, 256, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(20 + seed)
    with jax.disable_jit():
        ref = np.asarray(mae_augment(key, jnp.asarray(img), out_size=224))
    params = _jax_mae_draws(key, 4, 256)
    assert bool(params["flip"].any()) or seed
    out = taug.mae_augment(torch.from_numpy(img), params, out_size=224)
    assert out.dtype == torch.float32 and out.shape == (4, 224, 224, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_mae_sampler_ranges():
    """`sample_mae_params` by distribution: crop areas in [0.2, 1] of the
    canvas, aspect ratios in [3/4, 4/3], boxes inside the canvas, flips
    near one half."""
    p = taug.sample_mae_params(4096, torch.Generator().manual_seed(0),
                               canvas=256)
    x0, y0, w, h = p["box"].unbind(1)
    area = w * h / 256 ** 2
    assert float(area.min()) >= 0.2 * (1 - 1e-5)
    assert float(area.max()) <= 1.0 + 1e-5
    ratio = w / h
    assert float(ratio.min()) >= 0.75 * (1 - 1e-5)
    assert float(ratio.max()) <= 4 / 3 * (1 + 1e-5)
    assert float(x0.min()) >= 0 and float((x0 + w).max()) <= 256 + 1e-3
    assert float(y0.min()) >= 0 and float((y0 + h).max()) <= 256 + 1e-3
    assert abs(p["flip"].float().mean().item() - 0.5) < 0.03


def test_xavier_init_matches_flax():
    """`xavier_uniform_` against flax's xavier_uniform on 1000 x 1000
    draws: deviation within 1% and every value inside the bound; the MAE
    blocks use it (qkv at its (C, 3C) fans)."""
    import flax.linen as nn

    from ssl4gie_tpu_torch.models.layers import xavier_uniform_
    shape = (1000, 1000)
    ref = nn.initializers.xavier_uniform()(jax.random.PRNGKey(0), shape)
    t = xavier_uniform_(torch.empty(shape), 1000, 1000,
                        torch.Generator().manual_seed(0))
    bound = np.sqrt(6.0 / 2000)
    assert float(t.abs().max()) <= bound
    assert float(jnp.abs(ref).max()) <= bound
    assert abs(t.std().item() / float(jnp.std(ref)) - 1) < 0.01
    model = tmae.MAE(device="cpu", **SMALL[224])
    w = model.blocks[0].attn.qkv.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6.0 / (64 + 192))
    assert float(model.blocks[0].attn.qkv.bias.abs().max()) == 0.0


def test_full_width_param_tree_matches_jax():
    """The port's MAE ViT-B has the JAX tree's parameters one for one (the
    (1, 1, C) tokens included) and the converter's two directions are exact
    inverses on a random tree of the JAX shapes."""
    model = jmae.MAE(**jmae.MAE_SIZES["vit_b"])
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(0)},
        jnp.zeros((1, 224, 224, 3), jnp.float32)))["params"]
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)
    sd = mae_params_to_torch(tree)
    tmodel = tmae.MAE(device="cpu", **tmae.MAE_SIZES["vit_b"])
    assert {k: tuple(v.shape) for k, v in tmodel.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert tmodel.cls_token.shape == (1, 1, 768)
    assert tmodel.mask_token.shape == (1, 1, 512)
    back = mae_state_dict_to_params(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_full_step_runs_on_cpu_without_kernels():
    """`make_mae_full_step` on the CPU: augmentation, noise and the step
    from one generator; finite loss and gradient norm, parameters moved at
    step 1, and no kernel launch counted."""
    model = tmae.MAE(device="cpu", **SMALL[224])
    opt = tpre.make_mae_optimizer(model, PretrainConfig())
    full = tpre.make_mae_full_step(tpre.make_schedule(1e-3, 1, 10))
    img = torch.from_numpy(tpre.SyntheticUnlabeled(B).batch(range(B))[
        "image"])
    gen = torch.Generator().manual_seed(0)
    counts = (da.attention_fwd.launches, fm.mlp_fwd.launches)
    w0 = model.blocks[0].mlp.fc1.weight.detach().clone()
    outs = [full(model, opt, img, gen, i) for i in range(2)]
    assert all(np.isfinite(float(o["loss"])) and float(o["grad_norm"]) > 0
               for o in outs)
    assert not torch.equal(model.blocks[0].mlp.fc1.weight, w0)
    assert (da.attention_fwd.launches, fm.mlp_fwd.launches) == counts


@pytest.mark.parametrize("entry", ["classifier", "detector", "mae"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Built without a device, the port's models go to the card; without a
    card they raise instead of carrying on on the CPU."""
    from ssl4gie_tpu_torch.models.faster_rcnn import build_detector
    from ssl4gie_tpu_torch.models.vit import ViTClassifier
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {"classifier": lambda **kw: ViTClassifier(
                 6, depth=1, embed_dim=64, num_heads=1, **kw),
             "detector": lambda **kw: build_detector(
                 "vit_b", img_size=256, depth=1, embed_dim=64, num_heads=1,
                 **kw),
             "mae": lambda **kw: tmae.MAE(**SMALL[64], **kw)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
