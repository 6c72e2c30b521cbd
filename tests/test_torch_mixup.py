"""The MAE finetune recipe's targets and mixer in the port against the JAX
package's on the CPU: `smooth_one_hot`, the soft-target cross-entropy and
accuracy@k; both branches of `mixup_cutmix` at the draws of JAX's key
(rebuilt here and handed to the port's op); cutmix's lam equal to the
area kept; the sampler by distribution; the build's mixer; and one
float32 train step of a narrow ViT classifier (2 blocks of 64, 2 heads,
64 px) on mixed soft targets through the port's engine against
`jax.value_and_grad` of the JAX model on the same weights."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.data.augment import mixup_cutmix as jmixup
from ssl4gie_tpu.metrics import classification as jcls
from ssl4gie_tpu.models.vit import ViTClassifier as JaxViTClassifier
from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_train_step
from ssl4gie_tpu_torch.data.augment import (cutmix_box, mixup_cutmix,
                                            sample_mixup_params)
from ssl4gie_tpu_torch.metrics import classification as tcls
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.tasks import build as tbuild

torch.set_num_threads(1)

NARROW = dict(depth=2, embed_dim=64, num_heads=2)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_smooth_one_hot_matches_jax(smoothing):
    labels = np.array([0, 5, 2, 2, 1], np.int32)
    want = np.asarray(jcls.smooth_one_hot(jnp.asarray(labels), 6, smoothing))
    got = tcls.smooth_one_hot(torch.from_numpy(labels), 6, smoothing)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)


def test_soft_ce_and_topk_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 7)).astype(np.float32) * 3
    soft = rng.dirichlet(np.ones(7), 16).astype(np.float32)
    labels = rng.integers(0, 7, 16).astype(np.int32)
    want = float(jcls.soft_target_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(soft)))
    got = float(tcls.soft_target_cross_entropy(torch.from_numpy(logits),
                                               torch.from_numpy(soft)))
    assert abs(got - want) <= 1e-6 * abs(want)
    for ks in ((1, 5), (1, 3, 10)):
        want = [float(a) for a in jcls.accuracy_topk(
            jnp.asarray(logits), jnp.asarray(labels), ks)]
        got = [float(a) for a in tcls.accuracy_topk(
            torch.from_numpy(logits), torch.from_numpy(labels), ks)]
        assert got == want


def _jax_draws(key, H, W, mixup_alpha, cutmix_alpha, switch_prob=0.5):
    """The draws of JAX `mixup_cutmix(key, ...)` as the port's params."""
    k_lam_m, k_lam_c, k_switch, k_y, k_x = jax.random.split(key, 5)
    use_cutmix = cutmix_alpha > 0 and (
        mixup_alpha <= 0
        or bool(jax.random.uniform(k_switch, ()) < switch_prob))
    if use_cutmix:
        lam = float(jax.random.beta(k_lam_c, cutmix_alpha, cutmix_alpha))
    else:
        lam = float(jax.random.beta(k_lam_m, mixup_alpha, mixup_alpha))
    return {"use_cutmix": use_cutmix, "lam": lam,
            "cy": int(jax.random.randint(k_y, (), 0, H)),
            "cx": int(jax.random.randint(k_x, (), 0, W))}


@pytest.mark.parametrize("alphas,seed", [((0.8, 0.0), 0), ((0.0, 1.0), 1),
                                         ((0.0, 1.0), 4), ((0.8, 1.0), 2),
                                         ((0.8, 1.0), 3)])
def test_mixup_cutmix_matches_jax(alphas, seed):
    """Both branches at JAX's draws: the image and the targets within 1e-6,
    and cutmix's lam equal to the share of pixels kept."""
    B, H, W, n = 6, 20, 28, 5
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    soft = np.array(jcls.smooth_one_hot(
        jnp.asarray(rng.integers(0, n, B)), n, 0.1))
    key = jax.random.PRNGKey(seed)
    jimg, jtgt = jmixup(key, jnp.asarray(img), jnp.asarray(soft),
                        mixup_alpha=alphas[0], cutmix_alpha=alphas[1])
    params = _jax_draws(key, H, W, *alphas)
    timg, ttgt = mixup_cutmix(torch.from_numpy(img), torch.from_numpy(soft),
                              params)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ttgt.numpy(), np.asarray(jtgt), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ttgt.sum(1).numpy(), 1.0, atol=1e-6)
    if params["use_cutmix"]:
        (y0, y1, x0, x1), lam = cutmix_box(params["lam"], params["cy"],
                                           params["cx"], H, W)
        kept = (timg.numpy() == img).all(-1).mean()
        assert lam == pytest.approx(1 - (y1 - y0) * (x1 - x0) / (H * W),
                                    abs=1e-7)
        assert kept == pytest.approx(lam, abs=1e-7)
        np.testing.assert_allclose(ttgt.numpy(), lam * soft
                                   + (1 - lam) * soft[::-1], atol=1e-6)


def test_sample_mixup_params_by_distribution():
    """lam ~ Beta(0.8, 0.8) for mixup, Beta(1, 1) for cutmix, a fair coin
    between them, centres uniform over the pixels; a function of the
    generator's state."""
    gen = torch.Generator().manual_seed(0)
    draws = [sample_mixup_params(gen, 20, 30) for _ in range(4000)]
    cut = np.array([d["use_cutmix"] for d in draws])
    lam = np.array([d["lam"] for d in draws])
    assert abs(cut.mean() - 0.5) < 0.03
    mix = lam[~cut]   # Beta(0.8, 0.8): mean 0.5, var 0.64 / (2.56 * 2.6)
    assert abs(mix.mean() - 0.5) < 0.02
    assert abs(mix.var() - 0.64 / (2.56 * 2.6)) < 0.008
    assert abs(lam[cut].var() - 1 / 12) < 0.008          # Beta(1, 1)
    cy = np.array([d["cy"] for d in draws])
    cx = np.array([d["cx"] for d in draws])
    assert cy.min() == 0 and cy.max() == 19 and cx.max() == 29
    assert sample_mixup_params(torch.Generator().manual_seed(5), 8, 8) == \
        sample_mixup_params(torch.Generator().manual_seed(5), 8, 8)
    only_mix = sample_mixup_params(gen, 8, 8, mixup_alpha=0.8,
                                   cutmix_alpha=0.0)
    assert not only_mix["use_cutmix"]
    assert sample_mixup_params(gen, 8, 8, 0.0, 0.0)["lam"] == 1.0


def test_build_wires_the_mixer_and_soft_loss(tmp_path):
    """--mixup/--cutmix/--smoothing give the soft-target loss and a mixer
    whose targets are smoothed rows summing to 1; --smoothing alone only
    smooths; no flag keeps the weighted cross-entropy."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)

    def td_of(*extra):
        cfg = targs.to_train_config(p.parse_args(
            ["--task", "classification", "--synthetic", "--device", "cpu",
             "--compute-dtype", "float32", "--ckpt-dir", str(tmp_path),
             *extra]))
        return tbuild.make_task_definition(
            cfg, {"n_class": 6, "class_weights": [1.0] * 6}, "cpu")[0]

    img = torch.randn(4, 16, 16, 3)
    labels = torch.tensor([0, 1, 2, 3])
    td = td_of("--mixup", "0.8", "--cutmix", "1.0", "--smoothing", "0.1")
    assert td.loss_fn is tcls.soft_target_cross_entropy
    mixed, tgt = td.mixup_fn(img, labels, torch.Generator().manual_seed(0))
    assert mixed.shape == img.shape and tgt.shape == (4, 6)
    np.testing.assert_allclose(tgt.sum(1).numpy(), 1.0, atol=1e-6)
    td = td_of("--smoothing", "0.1")
    same, tgt = td.mixup_fn(img, labels, torch.Generator())
    assert same is img
    np.testing.assert_array_equal(tgt.numpy(), tcls.smooth_one_hot(
        labels, 6, 0.1).numpy())
    td = td_of()
    assert td.mixup_fn is None and td.aug_fn is None
    assert isinstance(td.loss_fn.keywords["class_weights"], torch.Tensor)


def test_soft_target_train_step_matches_jax():
    """One float32 step of a narrow ViT classifier at 64 px on mixed
    (cutmix) soft targets: the port's engine (`make_train_step`, SGD at
    rate 0 so the gradients stay readable) against jax.value_and_grad of
    the JAX model on the same weights; loss within 1e-5 relative, every
    gradient within 1e-4 of the largest."""
    B, S, n = 4, 64, 6
    rng = np.random.default_rng(7)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    soft = np.array(jcls.smooth_one_hot(
        jnp.asarray(rng.integers(0, n, B)), n, 0.1))
    params = _jax_draws(jax.random.PRNGKey(3), S, S, 0.0, 1.0)
    mimg, mtgt = mixup_cutmix(torch.from_numpy(img), torch.from_numpy(soft),
                              params)

    jmodel = JaxViTClassifier(num_classes=n, img_size=S,
                              out_token="global_pool", **NARROW)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, S, S, 3)))["params"]

    def loss(p):
        return jcls.soft_target_cross_entropy(
            jmodel.apply({"params": p}, jnp.asarray(mimg.numpy())),
            jnp.asarray(mtgt.numpy()))

    jloss, jgrads = jax.value_and_grad(loss)(jparams)
    jgrads = conv.vit_classifier_params_to_torch(jgrads)

    model = ViTClassifier(n, img_size=S, out_token="global_pool",
                          device="cpu", **NARROW)
    model.load_state_dict(conv.vit_classifier_params_to_torch(jparams))
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label",
                          loss_fn=tcls.soft_target_cross_entropy)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    out = make_train_step(task)(model, opt, {"image": mimg, "label": mtgt})
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-4, err_msg=name)
