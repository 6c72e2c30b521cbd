"""The port's ResNet-50 family against the JAX package's, in float32 on the
CPU, from one weight set: `ResNet50` in pooled and dense mode, at output
stride 32 and 16, with and without `mask_hw`, and on an odd-sized input off
the /32 grid (eval outputs; train-mode outputs, BatchNorm statistics and
gradients); its parameter count; the inits' distributions; the three full
models (`ResNetClassifier`, `DeepLabV3Plus` with the ASPP's dropout given
JAX's mask, `ResNetDepthModel`) at 64 px; the converters' round trips; the
entry points' default device; and two train steps of the RN50 DeepLabV3+
segmentation path (the seg augmentation, soft Dice, AdamW) with a narrowed
encoder.

The weights are the port's init with random biases, BatchNorm affines and
statistics (so that eval mode does not reduce to the init's identity),
handed to JAX by the inverse converters: JAX's own init of a full ResNet-50
takes some 20 s on one core. JAX runs op by op except in the train steps:
at these sizes that is quicker than compiling."""

import copy
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
from ssl4gie_tpu.metrics import segmentation as jseg
from ssl4gie_tpu.models import deeplabv3plus as jdl
from ssl4gie_tpu.models import resnet as jres
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core.train_state import make_adamw, set_lr
from ssl4gie_tpu_torch.core.trainer import make_full_step, make_train_step
from ssl4gie_tpu_torch.data import augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.models import factory
from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.resnet import ResNet50
from ssl4gie_tpu_torch.tasks.segmentation import segmentation_task
from test_torch_segmentation import jax_seg_augment, jax_segmentation_params

torch.set_num_threads(1)

B, S = 2, 64
LR = 1e-4
REL = 2e-4          # f32 outputs against JAX, relative to the largest
NARROW = (2, 1, 1, 2)   # identity blocks in layer1 and (dilated) layer4
TINY = (1, 1, 1, 1)
SEG_B, SEG_S = 4, 32    # path A's train steps (test_two_rn50_seg_...)
PARAMS_RN50 = 23_508_032     # tests/test_models.py:65


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to64(tree):
    """A tree in float64 (call under `jax.enable_x64(True)`)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _close(out, ref, rel=REL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=msg)


def _imgs(h=S, w=S, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (B, h, w, 3)).astype(
        np.float32)


@torch.no_grad()
def randomized(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """`module` with every bias, BatchNorm scale and BatchNorm statistic
    drawn at random, so that eval mode does not reduce to the init's
    identity."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
        if getattr(m, "bias", None) is not None:
            m.bias.normal_(0.0, 0.1, generator=gen)
    return module


def flax_dropout_keep(key, parent: str, shape, rate: float) -> np.ndarray:
    """The keep mask that flax's `Dropout(rate)` inside the top-level
    submodule `parent` draws from the dropout key `key`. flax derives a
    module's rng stream from the key and the module's path, so an empty
    module with the same path draws the same mask; this does not need the
    model's forward."""
    class Leaf(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(rate, deterministic=False)(x)

    class Root(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return Leaf(name=parent)(x)

    return np.asarray(Root().apply({}, jnp.ones(shape),
                                   rngs={"dropout": key})) != 0


def assert_stats_match(port_sd, want_sd, n_bn):
    names = [k for k in port_sd if k.endswith(("running_mean",
                                              "running_var"))]
    assert len(names) == 2 * n_bn
    for k in names:
        np.testing.assert_allclose(port_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _n_bn(stats) -> int:
    return len(jax.tree_util.tree_leaves(stats)) // 2


def jax_f64_train(model, params, stats, x, scalar=None, **kw):
    """The JAX train-mode forward in float64 (`model` built with dtype
    float64): (scalar(output), output, new batch_stats, the gradient of
    the scalar) as numpy, or without `scalar` (None, output, stats, None).
    These references are taken in float64 because XLA's float32 on the CPU
    is not accurate enough here: on the NARROW ResNet-50 its gradients
    drift from its own float64 ones by up to 6% of a tensor's largest
    element (the port's float32 by under 1e-5), and its running variances
    from the port's by 2e-5 (flax's fast variance, E[x^2] - E[x]^2, over
    float32 sums)."""
    with jax.enable_x64(True):
        def f(p):
            out, upd = model.apply({"params": p, "batch_stats": to64(stats)},
                                   jnp.asarray(x, jnp.float64), train=True,
                                   mutable=["batch_stats"], **kw)
            return (scalar(out) if scalar else 0.0), (out, upd)
        if scalar is None:
            _, (out, upd) = jax.jit(f)(to64(params))
            return None, _np_tree(out), _np_tree(upd["batch_stats"]), None
        (val, (out, upd)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            to64(params))
        return (float(val), _np_tree(out), _np_tree(upd["batch_stats"]),
                _np_tree(g))


# ---------------------------------------------------------------- ResNet50

def _backbone_sd(params, stats, stage_sizes):
    layers = conv._resnet_layers(stage_sizes)
    return conv._stats_to_torch(stats, layers, conv._to_torch(params, layers))


def _backbone_trees(port, stage_sizes):
    sd = conv._numpy(port.state_dict())
    layers = conv._resnet_layers(stage_sizes)
    return conv._to_flax(sd, layers), conv._stats_to_flax(sd, layers)


# (mode, output stride, input h x w, mask_hw, train mode and gradients)
RESNET_CASES = {
    "pooled-os32": ("pooled", 32, (S, S), None, False),
    "dense-os32": ("dense", 32, (S, S), None, False),
    "dense-os16": ("dense", 16, (S, S), None, False),
    "dense-os32-mask": ("dense", 32, (S, S), (32, 48), False),
    "pooled-odd-50x38": ("pooled", 32, (50, 38), None, False),
    "dense-os16-mask": ("dense", 16, (S, S), (64, 32), True),
    "dense-os16-odd-50x38": ("dense", 16, (50, 38), None, False),
}


@pytest.mark.parametrize("case", RESNET_CASES)
def test_resnet50_matches_jax(case):
    """Against the JAX `ResNet50` (NARROW stage sizes: every block kind):
    the eval output (random BatchNorm statistics); where the case says so,
    also the train-mode output, the updated BatchNorm statistics and the
    gradient of a weighted sum of the outputs (each tensor within 1e-4 of
    its largest element), against JAX in float64 (`jax_f64_train`). With
    `mask_hw`, what lies beyond the extent does not reach the outputs
    inside it."""
    mode, os_, (h, w), mask_hw, train = RESNET_CASES[case]
    kw = dict(mode=mode, output_stride=os_, stage_sizes=NARROW)
    mkw = {} if mask_hw is None else {"mask_hw": mask_hw}
    port = ResNet50(**kw)
    port.reset_parameters(torch.Generator().manual_seed(0))
    randomized(port)
    params, stats = _backbone_trees(port, NARROW)
    x = _imgs(h, w)
    xt = torch.from_numpy(x)
    as_list = (lambda o: [o]) if mode == "pooled" else list
    refs = as_list(jres.ResNet50(**kw).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), **mkw))
    with torch.no_grad():
        outs = as_list(port.eval()(xt, mask_hw))
    assert len(outs) == len(refs) == (1 if mode == "pooled" else 4)
    for o, r in zip(outs, refs):
        assert tuple(o.shape) == r.shape
        _close(o.numpy(), r)
    if mask_hw is not None:
        x2 = xt.clone()
        x2[:, mask_hw[0]:] = 7.0
        x2[:, :, mask_hw[1]:] = -7.0
        with torch.no_grad():
            outs2 = port(x2, mask_hw)
        for o, o2 in zip(outs, outs2):
            s = S // o.shape[1]
            inside = (slice(None), slice(mask_hw[0] // s),
                      slice(mask_hw[1] // s))
            np.testing.assert_array_equal(o[inside].numpy(),
                                          o2[inside].numpy())
    if not train:
        return
    # positive weights: a sum without cancellation
    wts = [np.random.default_rng(i).uniform(0.5, 1.5, r.shape).astype(
        np.float32) for i, r in enumerate(refs)]
    port.train()
    outs = as_list(port(xt, mask_hw))
    loss = sum(torch.sum(o * torch.from_numpy(wt))
               for o, wt in zip(outs, wts))
    loss.backward()
    ref_l, ref_out, upd, g = jax_f64_train(
        jres.ResNet50(dtype=jnp.float64, **kw), params, stats, x,
        lambda out: sum(jnp.sum(o * wt) for o, wt in zip(as_list(out), wts)),
        **mkw)
    for o, r in zip(outs, as_list(ref_out)):
        _close(o.detach().numpy(), r)
    np.testing.assert_allclose(loss.item(), ref_l, rtol=1e-5)
    want = _backbone_sd(g, upd, NARROW)
    for name, p in port.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-4, name)
    assert_stats_match(port.state_dict(), want, _n_bn(stats))


def test_resnet50_parameter_count():
    """The full backbone: 23,508,032 parameters, torchvision's ResNet-50
    without its fc (and the JAX package's, `tests/test_models.py`)."""
    n = sum(p.numel() for p in ResNet50().parameters())
    assert n == PARAMS_RN50


def test_inits_match_flax_distributions():
    """The body's convolutions draw flax's `variance_scaling(2.0,
    "fan_out", "normal")`, an untruncated normal of std sqrt(2 / (out * k
    * k)); the decoder's convolutions and `lin_head` flax's default
    `lecun_normal()`, truncated at 2 std of the untruncated draw, std
    sqrt(1 / fan_in), with a zero bias; the BatchNorms ones and zeros."""
    gen = torch.Generator().manual_seed(1)
    depth = factory.ResNetDepthModel(device="cpu", generator=gen)
    cls = factory.ResNetClassifier(6, device="cpu", generator=gen)
    enc = depth.encoder
    cases = [  # (weight, std, truncated?)
        (enc.layer3[0].conv2.weight, (2 / (256 * 9)) ** 0.5, False),
        (enc.layer3[0].conv3.weight, (2 / 1024) ** 0.5, False),
        (enc.layer3[0].downsample[0].weight, (2 / 1024) ** 0.5, False),
        (depth.level2.block0.conv2.weight, (1 / (64 * 9)) ** 0.5, True),
        (depth.level2.block0.id_conv.weight, (1 / 512) ** 0.5, True),
        (cls.lin_head.weight, (1 / 2048) ** 0.5, True)]
    for w, std, trunc in cases:
        w = w.detach().numpy()
        np.testing.assert_allclose(w.std(), std, rtol=0.05)
        ratio = np.abs(w).max() / w.std()
        # truncated at 2 std of the untruncated draw, 2.27 of its own
        assert (ratio < 2.3) if trunc else (ratio > 3.3), ratio
    for b in (depth.level2.block0.conv2.bias, cls.lin_head.bias):
        assert not b.any()
    bn = enc.layer1[0].bn1
    assert bn.weight.eq(1).all() and not bn.bias.any()
    assert enc.conv1.bias is None


# ----------------------------------------------------------- full models

FULL = {  # JAX model (of a dtype), port model, converter pair, output shape
    "classifier": (lambda dt=jnp.float32: jres.ResNetClassifier(6, dt),
                   lambda: factory.ResNetClassifier(6, device="cpu"),
                   (conv.resnet_classifier_params_to_torch,
                    conv.resnet_classifier_state_dict_to_params), (B, 6)),
    "deeplabv3plus": (lambda dt=jnp.float32: jdl.DeepLabV3Plus(1, dtype=dt),
                      lambda: factory.DeepLabV3Plus(1, device="cpu"),
                      (conv.deeplabv3plus_params_to_torch,
                       conv.deeplabv3plus_state_dict_to_params),
                      (B, S, S, 1)),
    "depth": (lambda dt=jnp.float32: jres.ResNetDepthModel(dt),
              lambda: factory.ResNetDepthModel(device="cpu"),
              (conv.resnet_depth_params_to_torch,
               conv.resnet_depth_state_dict_to_params), (B, S, S, 1)),
}


@functools.lru_cache(maxsize=None)
def _full(name):
    """The port's full model with random statistics and biases, and the
    same weights as JAX trees."""
    port = randomized(FULL[name][1]())
    params, stats = FULL[name][2][1](port.state_dict())
    return port, params, stats


@pytest.mark.parametrize("name", FULL)
def test_full_models_match_jax(name):
    """Each full-depth model at 64 px: the eval output, with random
    BatchNorm statistics, against JAX."""
    port, params, stats = _full(name)
    x = _imgs()
    ref = FULL[name][0]().apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert tuple(out.shape) == FULL[name][3] and out.dtype == torch.float32
    _close(out.numpy(), ref)
    if name == "depth":
        assert 0.0 <= out.min() and out.max() <= 1.0


@pytest.mark.parametrize("name", ["classifier", "depth"])
def test_train_mode_matches_jax(name, monkeypatch):
    """The classifier and the depth model in train mode, one block a stage
    (`TINY`), at 64 px: the output and the updated BatchNorm statistics
    against JAX in float64 (`jax_f64_train`). At full depth, train mode in
    float32 itself drifts from float64 by up to 4e-4 of the largest output
    and 3e-4 in the running statistics (the activations grow through 16
    residual blocks from a random init); DeepLabV3+'s train mode is held
    by the two train steps below."""
    monkeypatch.setattr(jres, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    port = randomized({"classifier": factory.ResNetClassifier,
                       "depth": factory.ResNetDepthModel}[name](
        *((6,) if name == "classifier" else ()), stage_sizes=TINY,
        device="cpu"))
    to_torch, to_params = FULL[name][2]
    params, stats = to_params(port.state_dict())
    x = _imgs()
    _, ref, upd, _ = jax_f64_train(FULL[name][0](jnp.float64), params, stats,
                                   x)
    with torch.no_grad():
        out = port.train()(torch.from_numpy(x))
    _close(out.numpy(), ref)
    assert_stats_match(port.state_dict(), to_torch(params, upd),
                       _n_bn(stats))


@pytest.mark.parametrize("name", FULL)
def test_converter_round_trip(name):
    """state_dict -> params and batch_stats with the JAX model's own tree
    structure and shapes -> the same state_dict, and back to the same
    trees, bit for bit; every parameter and BatchNorm buffer is covered."""
    port, params, stats = _full(name)
    to_torch, to_params = FULL[name][2]
    shapes = jax.eval_shape(FULL[name][0]().init,
                            {"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, S, S, 3)))
    for a, b in ((params, shapes["params"]),
                 (stats, shapes["batch_stats"])):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.shape == y.shape and x.dtype == np.float32
    sd = to_torch(params, stats)
    ref = port.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert torch.equal(v, ref[k]), k
    for a, b in zip((params, stats), to_params(sd)):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_resnet_body_uses_torchvision_names():
    names = set(factory.ResNetClassifier(6, device="cpu").state_dict())
    for n in ("backbone.conv1.weight", "backbone.bn1.running_var",
              "backbone.layer1.0.downsample.0.weight",
              "backbone.layer1.0.downsample.1.running_mean",
              "backbone.layer4.2.conv3.weight", "lin_head.bias"):
        assert n in names, n
    assert "backbone.layer2.1.downsample.0.weight" not in names


@pytest.mark.parametrize("cls", ["ResNetClassifier", "DeepLabV3Plus",
                                 "ResNetDepthModel"])
def test_rn50_models_build_on_the_card_by_default(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = (6,) if cls == "ResNetClassifier" else ()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(factory, cls)(*args, stage_sizes=(1, 1, 1, 1))


# ------------------------------------------------------- the train steps

def _adam_mu(opt_state):
    """The first moment tree inside the optax chain state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return _np_tree(leaf.mu)
    raise AssertionError("no adam state found")


def jax_two_steps(model, params, stats, td, batch, dropout_at=None):
    """Two steps of the JAX package's train step on one batch, the first at
    lr 0 (as a plateau scheduler can set it: both steps start from the same
    weights, while BatchNorm statistics and Adam's moments move), the
    second at LR. `dropout_at`: (parent, shape, rate) of the model's one
    dropout (`flax_dropout_keep`), or None. Returns each step's loss, its
    gradient tree (from Adam's first moment, mu = b1 mu + (1 - b1) g), its
    dropout keep mask (or None) and the final (params, batch_stats), as
    numpy."""
    state = TrainState.create(model.apply,
                              jax.tree_util.tree_map(jnp.array, params),
                              jax_make_adamw(LR),
                              jax.tree_util.tree_map(jnp.array, stats))
    step = jax_make_train_step(td, top_level=False)
    losses, grads, keeps, mu = [], [], [], None
    for i, lr in enumerate((0.0, LR)):
        k = jax.random.PRNGKey(20 + i)
        state = state.replace(opt_state=jax_set_lr(state.opt_state, lr))
        keeps.append(None if dropout_at is None
                     else flax_dropout_keep(k, *dropout_at))
        state, m = step(state, batch, k)
        losses.append(float(m["loss"]))
        new_mu = _adam_mu(state.opt_state)
        grads.append(jax.tree_util.tree_map(
            lambda a, b: (a - 0.9 * b) / 0.1, new_mu,
            jax.tree_util.tree_map(np.zeros_like, new_mu) if mu is None
            else mu))
        mu = new_mu
    return losses, grads, keeps, (_np_tree(state.params),
                                  _np_tree(state.batch_stats))


class WithMask(torch.nn.Module):
    """The port's model with its dropout mask given, as a test hands both
    packages one mask (None: the model draws nothing)."""

    def __init__(self, model):
        super().__init__()
        self.model, self.keep = model, None

    def forward(self, x, generator=None):
        if self.keep is None:
            return self.model(x, generator)
        return self.model(x, generator, self.keep)


def assert_port_steps_match(model, task, batch, jax_run, to_torch, stats):
    """The port's two steps (`make_train_step`) against `jax_two_steps`'s
    run: each step's loss 1e-5 relative and gradients 1e-4 (relative, and
    of the largest gradient element); after two steps every BatchNorm
    running statistic within 1e-5 and every parameter within 1e-5 of the
    largest parameter, except where Adam's step does not follow from the
    gradient: an element whose gradient lies within the gradients'
    agreement (1e-4 of the largest) at either step moves by about lr with a
    sign set by rounding (a qkv layer's key biases and the biases of a
    convolution before a train-mode BatchNorm, whose exact gradients are 0,
    are such elements); those are held within 2 lr, and fewer than 1
    element in 10,000 lies beyond 1e-5 of the largest."""
    losses, grads, keeps, (final_params, final_stats) = jax_run
    port = WithMask(model)
    opt = make_adamw(port.parameters(), LR)
    tstep = make_train_step(task)
    loose = {}
    for keep, ref_loss, ref_g, lr in zip(keeps, losses, grads, (0.0, LR)):
        set_lr(opt, lr)
        port.keep = None if keep is None else torch.from_numpy(keep)
        out = tstep(port, opt, batch)
        np.testing.assert_allclose(out["loss"].item(), ref_loss, rtol=1e-5)
        ref_g = to_torch(ref_g, stats)
        floor = 1e-4 * max(np.abs(ref_g[n].numpy()).max()
                           for n, _ in model.named_parameters())
        for name, p in model.named_parameters():
            g, want_g = p.grad.numpy(), ref_g[name].numpy()
            np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=floor,
                                       err_msg=name)
            small = np.abs(want_g) <= floor
            loose[name] = loose.get(name, small) | small
    want = to_torch(final_params, final_stats)
    largest = max(np.abs(want[n].numpy()).max()
                  for n, _ in model.named_parameters())
    n_far = n_all = 0
    for name, p in model.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        if name.endswith("attn.qkv.bias"):
            c = p.shape[0] // 3
            assert loose[name][c:2 * c].all(), name
        assert err[loose[name]].max(initial=0) <= 2 * LR * (1 + 1e-3), name
        assert err[~loose[name]].max(initial=0) <= 1e-5 * largest, \
            (name, err[~loose[name]].max())
        n_far += int((err > 1e-5 * largest).sum())
        n_all += p.numel()
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    assert_stats_match(model.state_dict(), want, _n_bn(final_stats))



def test_two_rn50_seg_train_steps_match_jax(monkeypatch):
    """Path A as a whole, one block a stage, B = 4 at 32 px: a uint8 batch
    and its mask through both packages' seg augmentation (JAX's factors
    handed to the port: image 1e-5, mask exactly), then two train steps of
    DeepLabV3+ on JAX's augmented batch (soft Dice, backward, AdamW;
    BatchNorm in train mode, the image-pool branch's over the B pooled
    values; the ASPP's dropout with the mask JAX draws at each step,
    `flax_dropout_keep`). Why B = 4 at 32 px: with B = 2 the image-pool
    BatchNorm normalises two values to +-1, its exact input gradient is
    about 0, and float32 rounding sends noise scaled by 1 / sigma into the
    encoder (the port's float32 gradients then differ from its own float64
    ones by 4.7% of a tensor's largest element at 64 px; at B = 4 and 64 px
    the images' pooled features differ too little, 4.3%); at B = 4 and 32
    px by under 5e-5."""
    monkeypatch.setattr(jdl, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    port = randomized(factory.DeepLabV3Plus(1, stage_sizes=TINY,
                                            device="cpu"))
    params, stats = conv.deeplabv3plus_state_dict_to_params(
        port.state_dict())
    rng = np.random.default_rng(7)
    img_u8 = rng.integers(0, 256, (SEG_B, SEG_S, SEG_S, 3), dtype=np.uint8)
    mask = (rng.random((SEG_B, SEG_S, SEG_S, 1)) > 0.5).astype(np.float32)
    akey = jax.random.PRNGKey(11)
    j_img, j_mask = jax_seg_augment(akey, img_u8, mask)
    t_img, t_mask = taug.apply_segmentation(
        torch.from_numpy(img_u8), torch.from_numpy(mask),
        jax_segmentation_params(akey, SEG_B, SEG_S))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    j_img = np.array(j_img)

    drop = ("aspp", (SEG_B, SEG_S // 16, SEG_S // 16, 256), 0.5)
    keep = flax_dropout_keep(jax.random.PRNGKey(3), *drop)
    assert 0.4 < keep.mean() < 0.6
    live = copy.deepcopy(port).train()
    with torch.no_grad():
        a, b = (live(torch.from_numpy(j_img), dropout_mask=torch.from_numpy(k))
                for k in (keep, ~keep))
    assert not torch.allclose(a, b)       # the mask reaches the output

    td = JaxTask(name="segmentation", aug_mode="segmentation",
                 target_key="mask", loss_fn=jseg.soft_dice_loss,
                 eval_metric_fn=None, has_dropout=True)
    run = jax_two_steps(jdl.DeepLabV3Plus(num_classes=1), params, stats, td,
                        {"image": j_img, "mask": j_mask}, drop)
    assert_port_steps_match(
        port, segmentation_task(),
        {"image": torch.from_numpy(j_img), "mask": t_mask}, run,
        conv.deeplabv3plus_params_to_torch, stats)


def test_rn50_seg_full_step_runs_on_cpu():
    """`make_full_step` with the seg task and DeepLabV3+: sampling, the
    augmentation, the step with the ASPP's dropout from the generator, on
    the CPU with no kernel build or launch; BatchNorm statistics move,
    losses are finite."""
    gen = torch.Generator().manual_seed(0)
    model = factory.DeepLabV3Plus(1, stage_sizes=TINY, device="cpu",
                                  generator=gen)
    opt = make_adamw(model.parameters(), LR)
    rng = np.random.default_rng(8)
    img_u8 = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3),
                                           dtype=np.uint8))
    mask = torch.from_numpy((rng.random((B, S, S, 1)) > 0.5).astype(
        np.float32))
    before = model.aspp.pool_bn.running_var.clone()
    counts = (da.attention_fwd.launches, rot.shear_rotate.launches)
    step = make_full_step(segmentation_task())
    losses = [step(model, opt, img_u8, mask, gen)["loss"].item()
              for _ in range(2)]
    assert np.all(np.isfinite(losses)) and 0 < losses[0] < 1
    assert not torch.equal(before, model.aspp.pool_bn.running_var)
    assert (da.attention_fwd.launches, rot.shear_rotate.launches) == counts
