"""The port's depth task against the JAX package's, in float32 on the CPU:
every function of `metrics/depth.py` (the SSI loss at alpha 0 and 0.1 and
its gradient through the closed-form alignment, the eval pair, the aligned
prediction, the eval metrics' median over an even count of valid pixels),
the depth augmentation at the factors JAX draws, two train steps of the ViT
+ DPT depth path, and the depth, RN50 depth and RN50 classification full
steps on the CPU (no kernel launched but the rotation's plain version).

The ViT is narrow (embed 64, 2 heads, DPT features (8, 16, 32, 64), fusion
16) at 224 px, the size whose 14 x 14 grid the port's position embedding
takes, with 4 blocks: the DPT decoder takes four taps, one after each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.core.trainer import TaskDefinition as JaxTask
from ssl4gie_tpu.data import augment as jaug
from ssl4gie_tpu.metrics import depth as jdepth
from ssl4gie_tpu_torch.convert.from_jax import (vit_dense_params_to_torch,
                                                vit_dense_state_dict_to_params)
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.data import augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.metrics import depth as tdepth
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models import factory
from ssl4gie_tpu_torch.tasks.depth import depth_task
from test_torch_augment import jax_classification_params
from test_torch_resnet import (TINY, assert_port_steps_match, jax_two_steps,
                               randomized)
from test_torch_segmentation import NARROW as NARROW_VIT
from test_torch_segmentation import JaxDense

torch.set_num_threads(1)

B, S = 2, 224
LR = 1e-4
REL = 2e-4          # f32 outputs against JAX, relative to the largest


def _depth_pair(seed, shape=(3, 32, 32)):
    """A prediction in (0, 1) and a target with about 30% invalid (zero)
    pixels; the last image has none valid (the alignment's singular
    case)."""
    rng = np.random.default_rng(seed)
    pred = rng.random(shape).astype(np.float32)
    target = (rng.random(shape) * 0.9 + 0.1).astype(np.float32)
    target[rng.random(shape) < 0.3] = 0.0
    target[-1] = 0.0
    return pred, target


def scene(rng, batch: int, size: int):
    """uint8 images and (B, H, W, 1) depth maps that go together, as a
    depth camera's do: each depth map a smooth random surface in [0.15,
    0.95], its image that surface's shading plus noise; 20% of the depth
    pixels invalid (0). (With a depth map drawn apart from its image, the
    SSI loss's gradient at a random init is a sum over the image that
    cancels to 1e-3 of its terms, below what float32 sums of 10^5 terms
    resolve.)"""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    depth = np.empty((batch, size, size, 1), np.float32)
    img = np.empty((batch, size, size, 3), np.uint8)
    for b in range(batch):
        f, ph = rng.uniform(1, 3, 2), rng.uniform(0, 6, 2)
        d = 0.55 + 0.4 * np.sin(np.pi * f[0] * yy + ph[0]) * \
            np.cos(np.pi * f[1] * xx + ph[1])
        depth[b, ..., 0] = d
        shade = 255 * d[..., None] + rng.normal(0, 20, (size, size, 3))
        img[b] = np.clip(shade, 0, 255).astype(np.uint8)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    return img, depth


def _close(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("alpha", [0.0, 0.1])
@pytest.mark.parametrize("channel_dim", [False, True])
def test_ssi_loss_and_gradient_match_jax(alpha, channel_dim):
    """The loss 1e-5 relative, its gradient with respect to the prediction
    (through the closed-form scale and shift) 1e-4 of its largest
    element, on (B, H, W) and (B, H, W, 1) inputs."""
    pred, target = _depth_pair(0)
    if channel_dim:
        pred, target = pred[..., None], target[..., None]
    ref, ref_g = jax.value_and_grad(
        lambda p: jdepth.ssi_loss(p, jnp.asarray(target), alpha=alpha))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = tdepth.ssi_loss(p, torch.from_numpy(target), alpha=alpha)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    _close(p.grad.numpy(), ref_g, 1e-4)
    assert p.grad[-1].abs().max() == 0      # no valid pixel, no gradient


def test_depth_parts_match_jax():
    """`compute_scale_and_shift` (zero on the singular image),
    `gradient_loss`, `aligned_prediction` and `ssi_eval_pair`: outputs
    within 2e-4 of the largest, the loss term 1e-5 relative."""
    pred, target = _depth_pair(1)
    mask = (target > 0).astype(np.float32)
    tp, tt, tm = (torch.from_numpy(a) for a in (pred, target, mask))
    jp, jt, jm = (jnp.asarray(a) for a in (pred, target, mask))
    for a, b in zip(tdepth.compute_scale_and_shift(tp, tt, tm),
                    jdepth.compute_scale_and_shift(jp, jt, jm)):
        _close(a.numpy(), b, REL)
        assert a[-1] == 0
    np.testing.assert_allclose(tdepth.gradient_loss(tp, tt, tm).item(),
                               float(jdepth.gradient_loss(jp, jt, jm)),
                               rtol=1e-5)
    _close(tdepth.aligned_prediction(tp, tt).numpy(),
           jdepth.aligned_prediction(jp, jt), REL)
    for a, b in zip(tdepth.ssi_eval_pair(tp[..., None], tt[..., None]),
                    jdepth.ssi_eval_pair(jp[..., None], jt[..., None])):
        _close(a.numpy(), b, REL)


def test_depth_eval_metrics_even_count_median():
    """RMSE, median relative error and absolute error per image, each image
    with an even count of valid pixels: the median is the mean of the two
    middle values, as `jnp.nanmedian` takes it (`torch.nanmedian` takes
    the lower one and misses here)."""
    rng = np.random.default_rng(2)
    pred = rng.random((3, 8, 8)).astype(np.float32) * 1.2 - 0.1
    target = (rng.random((3, 8, 8)) * 0.9 + 0.1).astype(np.float32)
    target.reshape(3, -1)[:, :14] = 0.0     # 50 valid pixels an image
    assert ((target > 0).sum(axis=(1, 2)) % 2 == 0).all()
    out = tdepth.depth_eval_metrics(torch.from_numpy(pred),
                                    torch.from_numpy(target))
    ref = jdepth.depth_eval_metrics(jnp.asarray(pred), jnp.asarray(target))
    for k in ("rmse", "med_rel_err", "abs_err"):
        _close(out[k].numpy(), ref[k], REL)
    # the lower middle value is not the JAX median here
    p = np.clip(pred, 0, 1) * 10
    rel = np.where(target > 0, np.abs(p - target * 10)
                   / np.maximum(target * 10, 1e-12), np.nan)
    lower = torch.nanmedian(torch.from_numpy(rel.reshape(3, -1)), dim=1)[0]
    assert not np.allclose(lower.numpy(), np.asarray(ref["med_rel_err"]),
                           rtol=1e-4)


# ------------------------------------------------------------ augmentation

def jax_depth_params(key, batch: int) -> dict:
    """The factors `augment_train_batch(key, ..., mode="depth")` draws:
    the classification branch's jitter, blur and flips (same key splits),
    without the angle."""
    p = jax_classification_params(key, batch)
    del p["angle"]
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_augmentation_matches_jax(seed):
    """The image (normalized float32) and the depth map (its dtype) after
    jitter, blur, normalize and the joint flips, fed the factors JAX drew:
    the depth map element for element, the image within 1e-5 (the jitter's
    float32 arithmetic, as the classification and seg branches' tests
    hold it)."""
    rng = np.random.default_rng(seed)
    img_u8 = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    depth = rng.random((B, 64, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    j_img, j_depth = jaug.augment_train_batch(key, jnp.asarray(img_u8),
                                              jnp.asarray(depth),
                                              mode="depth")
    params = jax_depth_params(key, B)
    assert params["hflip"].any() or params["vflip"].any()
    t_img, t_depth = taug.apply_depth(torch.from_numpy(img_u8),
                                      torch.from_numpy(depth), params)
    assert t_img.dtype == torch.float32 and t_depth.dtype == torch.float32
    np.testing.assert_array_equal(t_depth.numpy(), np.asarray(j_depth))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)


def test_depth_sampler():
    gen = torch.Generator().manual_seed(0)
    p = taug.sample_depth_params(4096, gen)
    assert set(p) == {"brightness", "contrast", "saturation", "hue", "order",
                      "sigma", "hflip", "vflip"}
    assert sorted(p["order"]) == [0, 1, 2, 3]
    for name in ("hflip", "vflip"):
        assert abs(p[name].float().mean().item() - 0.5) < 0.03


# ---------------------------------------------------------------- the steps

def test_two_vit_depth_train_steps_match_jax():
    """Path B as a whole: a uint8 batch and its depth map through both
    packages' depth augmentation (JAX's factors handed to the port), then
    two train steps of the ViT + DPT depth model on JAX's augmented batch
    (the SSI loss at alpha 0.1, backward, AdamW), held as the seg steps are
    (`test_torch_resnet.assert_port_steps_match`), on depth maps that go
    with their images (`scene`)."""
    port = randomized(factory.ViTDenseModel(dense="depth", device="cpu",
                                            **NARROW_VIT))
    params, _ = vit_dense_state_dict_to_params(port.state_dict())
    img_u8, depth = scene(np.random.default_rng(9), B, S)
    akey = jax.random.PRNGKey(13)
    j_img, j_depth = jaug.augment_train_batch(akey, jnp.asarray(img_u8),
                                              jnp.asarray(depth),
                                              mode="depth")
    t_img, t_depth = taug.apply_depth(torch.from_numpy(img_u8),
                                      torch.from_numpy(depth),
                                      jax_depth_params(akey, B))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_depth.numpy(), np.asarray(j_depth))

    td = JaxTask(name="depth", aug_mode="depth", target_key="depth",
                 loss_fn=functools.partial(jdepth.ssi_loss, alpha=0.1),
                 eval_metric_fn=None)
    run = jax_two_steps(JaxDense("depth"), params, {}, td,
                        {"image": j_img, "depth": j_depth})
    assert_port_steps_match(
        port, depth_task(),
        {"image": torch.from_numpy(np.array(j_img)), "depth": t_depth}, run,
        vit_dense_params_to_torch, {})


def _full_steps(model, task, img_u8, targets, n=2):
    gen = torch.Generator().manual_seed(0)
    opt = make_adamw(model.parameters(), LR)
    step = make_full_step(task)
    return [step(model, opt, img_u8, targets, gen)["loss"].item()
            for _ in range(n)]


@pytest.mark.parametrize("path", ["vit-depth", "rn50-depth", "rn50-cls"])
def test_full_steps_run_on_cpu(path):
    """`make_full_step` for paths B, C and D: sampling, the augmentation
    and the step on the CPU, finite losses, no kernel launched (path D's
    rotation runs the kernel's plain version on a CPU tensor, which counts
    no launch)."""
    rng = np.random.default_rng(10)
    size = S if path == "vit-depth" else 64
    img_u8 = torch.from_numpy(rng.integers(0, 256, (B, size, size, 3),
                                           dtype=np.uint8))
    counts = (da.attention_fwd.launches, da.attention_bwd.launches,
              rot.shear_rotate.launches)
    if path == "rn50-cls":
        model = factory.ResNetClassifier(6, stage_sizes=TINY, device="cpu")
        task = TaskDefinition(name="classification",
                              aug_mode="classification", target_key="label",
                              loss_fn=weighted_cross_entropy)
        targets = torch.from_numpy(rng.integers(0, 6, B))
    else:
        model = (factory.ViTDenseModel(dense="depth", device="cpu",
                                       **NARROW_VIT) if path == "vit-depth"
                 else factory.ResNetDepthModel(stage_sizes=TINY,
                                               device="cpu"))
        task = depth_task()
        targets = torch.from_numpy(rng.random((B, size, size, 1)).astype(
            np.float32))
    losses = _full_steps(model, task, img_u8, targets)
    assert np.all(np.isfinite(losses)) and losses[0] > 0
    assert (da.attention_fwd.launches, da.attention_bwd.launches,
            rot.shear_rotate.launches) == counts


def test_full_step_rejects_unported_modes():
    task = TaskDefinition(name="x", aug_mode="detection", target_key="boxes",
                          loss_fn=lambda o, t: o.sum())
    with pytest.raises(NotImplementedError, match="depth"):
        make_full_step(task)
