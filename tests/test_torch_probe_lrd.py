"""The linear probes and layer decay in the port against the JAX package's
on the CPU: `vit_layer_id` and the layer scales on the same parameters;
two AdamW steps with layer decay 0.65 and a plateau rate change between
them against `optax.chain(make_adamw, scale_by_layer_decay)`; two steps of
each probe (MoCo v3 SGD, MAE LARS with `head_bn`) against `make_probe_tx`;
`head_bn`'s forward in train and eval mode and its running statistics
against flax. Narrow ViT classifiers (2 blocks of 64, 2 heads) at 64 px
(the position grid interpolated), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl4gie_tpu.core.config import SSLFramework as JaxFramework
from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.core.train_state import set_lr as jax_set_lr
from ssl4gie_tpu.metrics.classification import weighted_cross_entropy as jce
from ssl4gie_tpu.models.vit import ViTClassifier as JaxViTClassifier
from ssl4gie_tpu.ssl import lr_decay as jlrd
from ssl4gie_tpu.ssl.probe import make_probe_tx, probe_head_trainable
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core.config import SSLFramework
from ssl4gie_tpu_torch.core.train_state import (apply_gradients, get_lr,
                                                make_adamw, set_lr)
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_train_step
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.ssl import lr_decay as tlrd
from ssl4gie_tpu_torch.ssl import probe as tprobe
from ssl4gie_tpu_torch.ssl.probe import make_probe_optimizer, reinit_head

torch.set_num_threads(1)

NARROW = dict(depth=2, embed_dim=64, num_heads=2)
S, N_CLASS, B = 64, 5, 8


def _jax_model(probe_bn=False, out_token="cls"):
    model = JaxViTClassifier(num_classes=N_CLASS, img_size=S,
                             out_token=out_token, probe_bn=probe_bn,
                             **NARROW)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # a non-zero head so that the features reach the loss
    params["lin_head"]["kernel"] = np.random.default_rng(1).normal(
        size=params["lin_head"]["kernel"].shape).astype(np.float32) * 0.3
    return model, params, variables.get("batch_stats", {})


def _port_model(params, probe_bn=False, out_token="cls"):
    model = ViTClassifier(N_CLASS, img_size=S, out_token=out_token,
                          probe_bn=probe_bn, device="cpu", **NARROW)
    missing, unexpected = model.load_state_dict(
        conv.vit_classifier_params_to_torch(params), strict=False)
    assert not unexpected and all(k.startswith("head_bn.") for k in missing)
    return model


def _jax_name(name):
    """A port parameter name as the JAX path's keys (blocks.{i} ->
    blocks_{i}); the leaf names do not matter to the layer id."""
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "blocks":
            out.append(f"blocks_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


@pytest.mark.parametrize("out_token", ["cls", "global_pool"])
def test_layer_ids_and_scales_match_jax(out_token):
    """On every parameter of the classifier: the layer id, and the scale
    tree of JAX `layer_decay_scales` carried to the port's names by the
    converter."""
    _, params = _jax_model(out_token=out_token)[:2]
    model = _port_model(params, out_token=out_token)
    names = [n for n, _ in model.named_parameters()]
    for depth in (2, 12):
        for n in names:
            assert tlrd.vit_layer_id(n, depth) == jlrd.vit_layer_id(
                _jax_name(n), depth), n
    jscales = jlrd.layer_decay_scales(params, depth=2, decay=0.65)
    filled = jax.tree_util.tree_map(
        lambda s, p: np.full(np.shape(p), s, np.float32), jscales, params)
    want = conv.vit_classifier_params_to_torch(filled)
    got = tlrd.layer_decay_scales(model, depth=2, decay=0.65)
    assert set(got) == set(want)
    for n, s in got.items():
        assert np.allclose(want[n].numpy(), np.float32(s), rtol=1e-7), n
    assert tlrd.vit_layer_id("lin_head.weight", 2) == 3
    assert tlrd.vit_layer_id("backbone.blocks.1.attn.qkv.weight", 2) == 2


def test_layer_decay_adamw_two_steps_match_optax():
    """Two AdamW steps (weight decay 0.05) with layer decay 0.65 and the
    base rate halved between them (a plateau step), against
    optax.chain(make_adamw, scale_by_layer_decay) with `set_lr` on its
    injected rate: every parameter within 1e-5; the groups keep their
    ratios and `get_lr` reads the base rate."""
    _, params = _jax_model()[:2]
    model = _port_model(params)
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        for _ in range(2)]
    lr, wd = 1e-2, 0.05
    tx = optax.chain(jax_make_adamw(lr, weight_decay=wd),
                     jlrd.scale_by_layer_decay(params, depth=2, decay=0.65))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    opt = make_adamw(tlrd.layer_decay_groups(model, depth=2, decay=0.65),
                     lr, weight_decay=wd)
    for step, g in enumerate(grads):
        if step == 1:
            state = jax_set_lr(state, lr / 2)
            set_lr(opt, lr / 2)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = optax.apply_updates(jp, upd)
        tg = conv.vit_classifier_params_to_torch(g)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        apply_gradients(opt)
    assert get_lr(opt) == lr / 2
    for group in opt.param_groups:
        assert group["lr"] == pytest.approx(lr / 2 * group["lr_scale"])
    want = conv.vit_classifier_params_to_torch(jp)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)


FRAMEWORKS = {"mocov3": (SSLFramework.MOCOV3, JaxFramework.MOCOV3),
              "mae": (SSLFramework.MAE, JaxFramework.MAE)}


@pytest.mark.parametrize("fw", ["mocov3", "mae"])
def test_probe_two_steps_match_jax(fw):
    """Two probe steps (the MAE probe with `head_bn` in train mode): the
    port's engine with `make_probe_optimizer` against `make_probe_tx`
    with gradients of the same loss (JAX updates the masked tree): the
    backbone bitwise unchanged, the head within 1e-5, `head_bn`'s running
    statistics within 1e-6; the backbone takes no gradient."""
    tfw, jfw = FRAMEWORKS[fw]
    probe_bn = fw == "mae"
    jmodel, params, stats = _jax_model(probe_bn=probe_bn)
    model = _port_model(params, probe_bn=probe_bn)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lr = 0.05
    opt = make_probe_optimizer(tfw, model, lr)
    assert [id(p) for g in opt.param_groups for p in g["params"]] == \
        [id(model.lin_head.weight), id(model.lin_head.bias)]
    tx = make_probe_tx(jfw, lr, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    step = make_train_step(TaskDefinition(
        name="classification", aug_mode="classification", target_key="label",
        loss_fn=weighted_cross_entropy))
    rng = np.random.default_rng(4)
    for _ in range(2):
        img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
        labels = rng.integers(0, N_CLASS, B).astype(np.int32)

        def loss(p, bs):
            variables = {"params": p, "batch_stats": bs}
            if probe_bn:
                logits, new = jmodel.apply(variables, jnp.asarray(img),
                                           train=True,
                                           mutable=["batch_stats"])
                return jce(logits, jnp.asarray(labels)), new["batch_stats"]
            return jce(jmodel.apply(variables, jnp.asarray(img),
                                    train=True), jnp.asarray(labels)), bs

        (_, stats), g = jax.value_and_grad(loss, has_aux=True)(jp, stats)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        step(model, opt, {"image": torch.from_numpy(img),
                          "label": torch.from_numpy(labels)})
    for n, p in model.named_parameters():
        if n.startswith("backbone."):
            assert torch.equal(p, before[n]) and p.grad is None, n
    want = conv.vit_classifier_params_to_torch(jp)
    for n in ("lin_head.weight", "lin_head.bias"):
        got = model.get_parameter(n).detach()
        assert not torch.equal(got, before[n])
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
    if probe_bn:
        for jk, tk in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(model.head_bn, tk).numpy(),
                np.asarray(stats["head_bn"][jk]), rtol=0, atol=1e-6)
    for n, _ in model.named_parameters():
        assert tprobe.probe_head_trainable(n) == probe_head_trainable(
            _jax_name(n)), n


def test_head_bn_forward_matches_flax():
    """`head_bn` in the MAE probe classifier: train-mode logits and the
    updated running statistics, then eval-mode logits on them, against
    flax's BatchNorm(momentum 0.9, eps 1e-6, no scale, no bias)."""
    jmodel, params, stats = _jax_model(probe_bn=True)
    model = _port_model(params, probe_bn=True)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want, new = jmodel.apply(variables, jnp.asarray(img), train=True,
                             mutable=["batch_stats"])
    model.train()
    got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    for jk, tk in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(model.head_bn, tk).numpy(),
                                   np.asarray(new["batch_stats"]["head_bn"][jk]),
                                   rtol=0, atol=1e-6)
    model.eval()
    want = jmodel.apply({"params": params,
                         "batch_stats": new["batch_stats"]},
                        jnp.asarray(img), train=False)
    got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    assert not list(model.head_bn.parameters())


def test_reinit_head():
    """N(0, 0.01) weights from the generator, zero bias, nothing else
    touched."""
    _, params = _jax_model()[:2]
    model = _port_model(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reinit_head(model, torch.Generator().manual_seed(0))
    w = model.lin_head.weight.detach()
    assert abs(w.std().item() - 0.01) < 0.002
    assert torch.equal(model.lin_head.bias, torch.zeros(N_CLASS))
    for n, p in model.named_parameters():
        if not n.startswith("lin_head."):
            assert torch.equal(p, before[n])
