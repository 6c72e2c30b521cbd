"""The port's MoCo v3 slice against the JAX package's, on the CPU, from one
weight set (the port's init handed to JAX by the inverse converters):
`contrastive_loss`, `MLPHead` and the conv stem (forward, gradients,
BatchNorm statistics), LARS over three steps against the optax
transformation, the cosine schedules, `moco_two_crops` at the values the
JAX pipeline draws from its key, the converters' round trip, and two whole
`make_moco_train_step` steps for a narrow ViT (AdamW, the frozen patch
projection) and a narrow ResNet-50 (LARS): loss, gradient norm,
parameters, momentum parameters and both sets of statistics.

The narrow ViT is the `vit_b` preset cut to width 64, depth 2, 2 heads at
224 px, set in both packages' `VIT_PRESETS` by monkeypatch. The ResNet-50
steps hold the port's float32 against JAX in float64 (`jax.enable_x64`):
XLA's float32 on the CPU drifts several percent from its own float64 on
BatchNorm ResNets in train mode (`tests/test_torch_resnet.py`). Inputs
differ in scale from image to image: the projector's BatchNorm divides by
the batch's spread, which random noise of one scale leaves small enough
to magnify float32 rounding a hundredfold."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl4gie_tpu.core import schedule as jsched
from ssl4gie_tpu.data import ssl_augment as jaug
from ssl4gie_tpu.models import layers as jlayers
from ssl4gie_tpu.models import resnet as jres
from ssl4gie_tpu.ssl import lars as jlars
from ssl4gie_tpu.ssl import moco_v3 as jmoco
from ssl4gie_tpu.ssl import pretrain as jpre
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core import schedule as tsched
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.data import ssl_augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.vit import ConvStem
from ssl4gie_tpu_torch.ssl import moco_v3 as tmoco
from ssl4gie_tpu_torch.ssl.lars import LARS
from ssl4gie_tpu_torch.ssl.pretrain import wd_mask

torch.set_num_threads(1)

REL = 1e-5              # float32 against JAX, relative to the largest
NARROW_VIT = dict(embed_dim=64, depth=2, num_heads=2)
TINY = (1, 1, 1, 1)     # one bottleneck a stage
DIM, MLP_DIM, T = 16, 32, 0.2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(out, ref, rel=REL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=msg)


def _tree_close(port_sd, want_sd, rel=REL, skip=None):
    assert port_sd.keys() == want_sd.keys(), set(port_sd) ^ set(want_sd)
    for k in port_sd:
        a, b = port_sd[k].detach().numpy(), want_sd[k].numpy()
        if skip is not None and skip(k) is not None:
            sl = skip(k)
            a, b = a.copy(), b.copy()
            a[sl] = b[sl] = 0
        _close(a, b, rel, k)


def _varied(n, hw, seed):
    """(n, hw, hw, 3) float32 images of different scales and offsets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, hw, hw, 3))
    scale = np.linspace(0.5, 2.0, n)[:, None, None, None]
    shift = np.linspace(-1.0, 1.0, n)[::-1, None, None, None]
    return (x * scale + shift).astype(np.float32)


@torch.no_grad()
def _randomize_bn(module, seed=0):
    """Random BatchNorm affines and running statistics (so that neither
    mode reduces to the init's identity)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            if m.weight is not None:
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("temperature", [0.2, 1.0])
def test_contrastive_loss_and_gradients_match_jax(temperature):
    """The loss and both inputs' gradients within 1e-6 (relative)."""
    rng = np.random.default_rng(0)
    q, k = rng.normal(0, 1, (2, 8, 16)).astype(np.float32)
    ref, (gq, gk) = jax.value_and_grad(
        lambda a, b: jmoco.contrastive_loss(a, b, temperature),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    out = tmoco.contrastive_loss(tq, tk, temperature)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    _close(tq.grad, gq, 1e-6)
    _close(tk.grad, gk, 1e-6)


# ------------------------------------------------------------ the heads

@pytest.mark.parametrize("num_layers", [2, 3])
def test_mlp_head_matches_jax(num_layers):
    """Train mode: the output, every parameter's and the input's gradient
    and the updated running statistics; eval mode: the output. The last
    BatchNorm has no scale or bias (no parameters in either package)."""
    head = tmoco.MLPHead(24, num_layers, MLP_DIM, DIM)
    head.reset_parameters(torch.Generator().manual_seed(1))
    _randomize_bn(head)
    layers = conv._mlp_head_layers(num_layers)
    sd = conv._numpy(head.state_dict())
    params, stats = conv._to_flax(sd, layers), conv._stats_to_flax(sd, layers)
    assert f"bn{num_layers - 1}" not in params
    jhead = jmoco.MLPHead(num_layers, MLP_DIM, DIM)
    x = (np.random.default_rng(3).normal(0, 1, (8, 24))
         * np.linspace(0.5, 2.0, 8)[:, None]).astype(np.float32)
    wt = np.random.default_rng(4).normal(0, 1, (8, DIM)).astype(np.float32)

    def f(p, xx):
        out, upd = jhead.apply({"params": p, "batch_stats": stats}, xx,
                               train=True, mutable=["batch_stats"])
        return jnp.sum(out * wt), (out, upd["batch_stats"])

    (_, (ref, new_stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = head.train()(tx)
    (out * torch.from_numpy(wt)).sum().backward()
    _close(out.detach(), ref)
    _close(tx.grad, gx)
    want = conv._stats_to_torch(_np_tree(new_stats), layers,
                                conv._to_torch(_np_tree(gp), layers))
    got = {k: v for k, v in head.state_dict().items() if "running" in k}
    got.update({n: p.grad for n, p in head.named_parameters()})
    _tree_close(got, want)
    ref_eval = jhead.apply({"params": params, "batch_stats": new_stats},
                           jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(head.eval()(torch.from_numpy(x)), ref_eval)


def test_conv_stem_matches_jax():
    """`ConvStem` (width 32: stages of 4, 8, 16, 32 channels) on a 64 px
    batch: train-mode tokens, grid, every parameter's gradient and the
    running statistics, and the eval-mode tokens, within 1e-5 of the
    largest."""
    stem = ConvStem(32)
    stem.reset_parameters(torch.Generator().manual_seed(0))
    _randomize_bn(stem)
    layers = conv._conv_stem_layers()
    sd = conv._numpy(stem.state_dict())
    params, stats = conv._to_flax(sd, layers), conv._stats_to_flax(sd, layers)
    jstem = jlayers.ConvStem(32)
    x = _varied(2, 64, 5)
    wt = np.random.default_rng(6).normal(0, 1, (2, 16, 32)).astype(
        np.float32)

    def f(p):
        (tok, grid), upd = jstem.apply({"params": p, "batch_stats": stats},
                                       jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        return jnp.sum(tok * wt), (tok, grid, upd["batch_stats"])

    (_, (ref, grid, new_stats)), gp = jax.value_and_grad(
        f, has_aux=True)(params)
    out, tgrid = stem.train()(torch.from_numpy(x))
    (out * torch.from_numpy(wt)).sum().backward()
    assert tgrid == tuple(grid) == (4, 4)
    _close(out.detach(), ref)
    want = conv._stats_to_torch(_np_tree(new_stats), layers,
                                conv._to_torch(_np_tree(gp), layers))
    got = {k: v for k, v in stem.state_dict().items() if "running" in k}
    got.update({n: p.grad for n, p in stem.named_parameters()})
    _tree_close(got, want, 1e-4)
    (ref_eval, _) = jstem.apply({"params": params,
                                 "batch_stats": new_stats},
                                jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(stem.eval()(torch.from_numpy(x))[0], ref_eval)


# ----------------------------------------------------- optimizer, schedules

@pytest.mark.parametrize("scheduled", [False, True])
def test_lars_three_steps_match_optax(scheduled):
    """Three LARS steps (weight decay 0.1, trust ratio, heavy ball) on a
    matrix, a bias (no decay, no ratio), an all-zero matrix (|p| = 0:
    ratio 1) and a conv kernel, with a constant rate or a schedule of
    LARS's own count (starting at 0): parameters and momentum buffers
    within 1e-6 relative."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 4), "b": (4,), "zero": (3, 3), "k": (2, 3, 3, 3)}
    params = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in
              shapes.items()}
    params["zero"][:] = 0
    grads = [{n: rng.normal(0, 1, s).astype(np.float32) for n, s in
              shapes.items()} for _ in range(3)]
    lr = (lambda c: 0.3 * (1.0 + c)) if scheduled else 0.3
    tx = jlars.lars(lr, weight_decay=0.1)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in
          params.items()}
    opt = LARS(list(tp.values()), lr=lr, weight_decay=0.1)
    for g in grads:
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()
    mu = (state[0] if scheduled else state).mu
    for n, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(opt.state[p]["mu"].numpy(),
                                   np.asarray(mu[n]), rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    assert opt.param_groups[0]["count"] == 3
    if scheduled:
        assert opt.param_groups[0]["lr"] == pytest.approx(0.9)
        # the count travels with the state dict
        opt2 = LARS(list(tp.values()), lr=lr, weight_decay=0.1)
        opt2.load_state_dict(opt.state_dict())
        assert opt2.param_groups[0]["count"] == 3


@pytest.mark.parametrize("base_m,total", [(0.99, 100), (0.996, 3000)])
def test_cosine_momentum_matches_jax(base_m, total):
    for step in (0, 1, 7, total // 3, total // 2, total - 1, total):
        ref = float(jsched.cosine_momentum(step, base_m=base_m,
                                           total_steps=total))
        got = tsched.cosine_momentum(step, base_m=base_m, total_steps=total)
        np.testing.assert_allclose(got, ref, rtol=2.5e-7, err_msg=str(step))
    assert tsched.cosine_momentum(0, base_m=base_m,
                                  total_steps=total) == pytest.approx(base_m)


@pytest.mark.parametrize("warmup,total,min_lr", [(0, 10, 0.0), (5, 20, 0.0),
                                                 (40, 400, 1e-6)])
def test_cosine_warmup_lr_matches_jax(warmup, total, min_lr):
    kw = dict(base_lr=1.5e-4, warmup_steps=warmup, total_steps=total,
              min_lr=min_lr)
    for step in sorted({0, 1, warmup // 2, max(warmup - 1, 0), warmup,
                        (warmup + total) // 2, total - 1, total}):
        np.testing.assert_allclose(tsched.cosine_warmup_lr(step, **kw),
                                   float(jsched.cosine_warmup_lr(step, **kw)),
                                   rtol=2.5e-7, atol=1e-12, err_msg=str(step))


# ----------------------------------------------------------- augmentation

def _jax_view_draws(key, batch, canvas, blur_p, solarize_p):
    """One view's values as `_byol_view` draws them from `key` (its eleven
    key splits, the crop's four), replayed op by op; the port's
    `crop_boxes` of the same unit draws is held to the JAX boxes within 2
    float32 ulps or 1e-5 px (XLA's and torch's exp and sqrt may round
    apart; see `test_torch_mae.py::_jax_mae_draws`)."""
    u = jax.random.uniform
    k = jax.random.split(key, 11)
    ka, kr, kx, ky = jax.random.split(k[0], 4)
    area_frac = u(ka, (batch,), minval=0.08, maxval=1.0)
    log_r = u(kr, (batch,), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))
    ux, uy = u(kx, (batch,)), u(ky, (batch,))
    area = area_frac * (canvas * canvas)
    r = jnp.exp(log_r)
    w = jnp.clip(jnp.sqrt(area * r), 1.0, canvas)
    h = jnp.clip(jnp.sqrt(area / r), 1.0, canvas)
    box = jnp.stack([ux * (canvas - w), uy * (canvas - h), w, h], axis=1)
    t = lambda a: torch.from_numpy(np.array(a)).reshape(batch)
    ours = taug.crop_boxes(*(torch.from_numpy(np.array(a)) for a in
                             (area_frac, log_r, ux, uy)), canvas, canvas)
    np.testing.assert_allclose(ours.numpy(), np.asarray(box), rtol=2.5e-7,
                               atol=1e-5)
    mask = lambda i, p: t(u(k[i], (batch, 1, 1, 1)) < p)
    return {"box": torch.from_numpy(np.array(box)),
            "brightness": t(u(k[1], (batch, 1, 1, 1), minval=0.6,
                              maxval=1.4)),
            "contrast": t(u(k[2], (batch, 1, 1, 1), minval=0.6, maxval=1.4)),
            "saturation": t(u(k[3], (batch, 1, 1, 1), minval=0.8,
                              maxval=1.2)),
            "hue": t(u(k[4], (batch, 1, 1), minval=-0.1, maxval=0.1)),
            "jitter": mask(5, 0.8), "gray": mask(6, 0.2),
            "sigma": t(u(k[7], (batch, 1), minval=0.1, maxval=2.0)),
            "blur": mask(8, blur_p),
            "solarize": (mask(9, solarize_p) if solarize_p > 0
                         else torch.zeros(batch, dtype=torch.bool)),
            "flip": t(u(k[10], (batch, 1, 1, 1)) > 0.5)}


def jax_moco_draws(key, batch, canvas=256):
    """Both views' values of `moco_two_crops(key, ...)`."""
    with jax.disable_jit():
        k1, k2 = jax.random.split(key)
        return (_jax_view_draws(k1, batch, canvas, 1.0, 0.0),
                _jax_view_draws(k2, batch, canvas, 0.1, 0.2))


def test_moco_two_crops_matches_jax():
    """Both views at the values the JAX pipeline draws from one key (f32,
    256 px canvases to 224): within 1e-5, the JAX function run op by op
    (as in test_torch_mae.py). The draws exercise every branch: jitter on
    and off, grayscale, view 2's blur on and off, solarize, flips."""
    img = np.random.default_rng(0).integers(0, 256, (8, 256, 256, 3),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    p1, p2 = jax_moco_draws(key, 8)
    for name, view in (("jitter", p1), ("gray", p1), ("blur", p2),
                       ("solarize", p2), ("flip", p1)):
        assert 0 < int(view[name].sum()) < 8, name
    with jax.disable_jit():
        ref = jaug.moco_two_crops(key, jnp.asarray(img), out_size=224)
    out = taug.moco_two_crops(torch.from_numpy(img), (p1, p2), out_size=224)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and o.shape == (8, 224, 224, 3)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_moco_sampler_ranges():
    """`sample_moco_params` by distribution: areas in [0.08, 1] of the
    canvas, the factors in their ranges, masks near their probabilities
    (blur 1.0 / 0.1, solarize 0 / 0.2), flips near one half."""
    p1, p2 = taug.sample_moco_params(4096, torch.Generator().manual_seed(0))
    for p in (p1, p2):
        x0, y0, w, h = p["box"].unbind(1)
        area = w * h / 256 ** 2
        assert float(area.min()) >= 0.08 * (1 - 1e-5)
        assert float(area.max()) <= 1.0 + 1e-5
        for k, (lo, hi) in taug.MOCO_JITTER.items():
            assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
        assert 0.1 <= float(p["sigma"].min()) <= float(p["sigma"].max()) <= 2
        for k, want in (("jitter", 0.8), ("gray", 0.2), ("flip", 0.5)):
            assert abs(p[k].float().mean().item() - want) < 0.03, k
    assert bool(p1["blur"].all()) and not bool(p1["solarize"].any())
    assert abs(p2["blur"].float().mean().item() - 0.1) < 0.03
    assert abs(p2["solarize"].float().mean().item() - 0.2) < 0.03


# ------------------------------------------------------- model and steps

def _narrow_vit(monkeypatch):
    for presets in (jmoco.VIT_PRESETS, tmoco.VIT_PRESETS):
        for arch in ("vit_b", "vit_conv_b"):
            monkeypatch.setitem(presets, arch,
                                dict(presets[arch], **NARROW_VIT))


@pytest.mark.parametrize("arch", ["vit_b", "vit_conv_b", "resnet50"])
def test_converter_round_trip_and_jax_tree(monkeypatch, arch):
    """`moco_state_dict_to_params` then `moco_params_to_torch` gives the
    state dict back exactly, and the JAX trees have the structure and
    shapes of the JAX package's init (the momentum trees the encoder's)."""
    _narrow_vit(monkeypatch)
    monkeypatch.setattr(jmoco, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    port = tmoco.MoCo(arch, DIM, MLP_DIM, stage_sizes=TINY, device="cpu")
    trees = conv.moco_state_dict_to_params(port.state_dict())
    back = conv.moco_params_to_torch(*trees)
    ref = port.state_dict()
    assert back.keys() == ref.keys()
    for k in ref:
        assert torch.equal(back[k], ref[k]), k
    hw = 64 if arch == "resnet50" else 224
    x = jnp.zeros((2, hw, hw, 3))
    shape = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)
    enc = jax.eval_shape(lambda: jmoco.MoCoEncoder(arch, DIM, MLP_DIM).init(
        jax.random.PRNGKey(0), x))
    pred = jax.eval_shape(lambda: jmoco.MoCoPredictor(DIM, MLP_DIM).init(
        jax.random.PRNGKey(0), jnp.zeros((2, DIM))))
    params, stats, mom, mom_stats = trees
    assert shape(params) == shape({"encoder": enc["params"],
                                   "predictor": pred["params"]})
    assert shape(stats) == shape({"encoder": enc.get("batch_stats", {}),
                                  "predictor": pred["batch_stats"]})
    assert shape(mom) == shape(enc["params"])
    assert shape(mom_stats) == shape(enc.get("batch_stats", {}))


def _jax_moco_steps(arch, trees, tx, views, ms, dtype):
    """The JAX package's `make_moco_train_step` from `trees` (in `dtype`),
    once per view pair: after each step, (the MoCoState's params,
    batch_stats, momentum params and momentum batch_stats as numpy copies,
    (loss, grad_norm))."""
    params, stats, mom, mom_stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), trees)
    enc = jmoco.MoCoEncoder(arch, DIM, MLP_DIM, dtype=dtype)
    pred = jmoco.MoCoPredictor(DIM, MLP_DIM, dtype=dtype)
    state = jmoco.MoCoState(step=jnp.zeros((), jnp.int32), params=params,
                            momentum_params=mom, batch_stats=stats,
                            momentum_batch_stats=mom_stats,
                            opt_state=tx.init(params), tx=tx)
    step = jmoco.make_moco_train_step(enc, pred, T)
    copy = lambda t: jax.tree_util.tree_map(lambda a: np.array(a), t)
    out = []
    for (x1, x2), m in zip(views, ms):
        state, met = step(state, jnp.asarray(x1, dtype),
                          jnp.asarray(x2, dtype), jnp.asarray(m, dtype))
        trees = (copy(state.params), copy(state.batch_stats),
                 copy(state.momentum_params),
                 copy(state.momentum_batch_stats))
        moments = {k: optax.tree_utils.tree_get(state.opt_state, k)
                   for k in ("mu", "nu")}
        out.append((trees, {k: None if v is None else copy(v)
                            for k, v in moments.items()},
                    (float(met["loss"]), float(met["grad_norm"]))))
    return out


# the optimizers' moment buffers: optax's name -> torch's
_MOMENTS = {"adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "lars": {"mu": "mu"}}


@torch.no_grad()
def _hand_state(port, opt, trees, moments, kind):
    """JAX's state after a step into the port: parameters, momentum
    parameters and running statistics, and the optimizer's moments."""
    port.load_state_dict(conv.moco_params_to_torch(*trees))
    named = dict(port.named_parameters())
    for src, dst in _MOMENTS[kind].items():
        sd = conv.moco_params_to_torch(moments[src], *trees[1:])
        for name, p in named.items():
            if p in opt.state:
                opt.state[p][dst].copy_(sd[name])


def _port_steps_match(port, opt, kind, step_fn, views, ms, ref, rel,
                      update_tol, adam_lr=None):
    """The port's step from the state JAX started each step from: its loss
    and gradient norm within `rel` relative, then every tensor of the
    state (parameters, momentum parameters, running statistics) within
    `rel` of the largest of its tensor plus, for a parameter, the
    allowance `update_tol(step, largest |gradient| of all)` for its
    update; then JAX's state, the optimizer's moments included, is handed
    to the port for the next step (`_hand_state`), so that each step
    starts from one state in both packages. Exempt, as float32 noise that no port can
    match:
    - under Adam (`adam_lr(step)`), the elements whose gradient is below
      1e-4 of its tensor's largest or 1e-6 of the largest of all
      (Adam's update there is the sign of rounding noise times lr: within
      2 lr; the final LayerNorm's bias has only such gradients, since the
      projector's BatchNorm cancels any shift of its input);
    - running statistics within 1e-6 absolute (the predictor's first
      BatchNorm sees the batch-centred projector output: a running mean of
      rounding noise about 1e-8)."""
    for i, ((x1, x2), m) in enumerate(zip(views, ms)):
        out = step_fn(port, opt, torch.from_numpy(x1), torch.from_numpy(x2),
                      m, i)
        trees, moments, (ref_loss, ref_gn) = ref[i]
        np.testing.assert_allclose(out["loss"].item(), ref_loss, rtol=rel)
        np.testing.assert_allclose(out["grad_norm"].item(), ref_gn,
                                   rtol=rel)
        grads = {k: np.abs(p.grad.numpy()) for k, p in
                 port.named_parameters() if p.grad is not None}
        g_all = max(g.max() for g in grads.values())
        want = conv.moco_params_to_torch(*trees)
        got = port.state_dict()
        assert got.keys() == want.keys()
        for k, v in got.items():
            a, b = v.numpy(), want[k].numpy()
            err = np.abs(a - b)
            tol = rel * np.abs(b).max() + (1e-6 if "running" in k else 0.0)
            if k in grads:
                tol += update_tol(i, g_all)
            if adam_lr is not None and k in grads:
                g = grads[k]
                noise = (g < 1e-4 * g.max()) | (g < 1e-6 * g_all)
                assert (err[noise] <= 2 * adam_lr(i) * (1 + 1e-3)).all(), k
                err = np.where(noise, 0.0, err)
            assert err.max() <= tol, (i, k, err.max(), tol, g_all)
        _hand_state(port, opt, trees, moments, kind)


def test_two_vit_steps_match_jax(monkeypatch):
    """Two MoCo v3 steps of the narrow vit_b (B = 8 at 224 px; AdamW with
    betas (0.9, 0.95), weight decay 0.1 on ndim > 1, a rate of the step;
    the patch projection frozen, as `run_pretraining` chains
    `optax.masked(set_to_zero())`; the momentum of `cosine_momentum`),
    each from the state JAX started it from (`_port_steps_match`: 1e-5,
    each Adam update within 1e-3 lr: Adam divides a gradient's rounding
    noise by sqrt(v), which magnifies it where the gradient is small); the
    patch
    projection bitwise unchanged in both encoders; no kernel
    launches (the attention at N = 197 takes the kernel's route, whose
    plain version runs on the CPU)."""
    _narrow_vit(monkeypatch)
    port = tmoco.MoCo("vit_b", DIM, MLP_DIM, device="cpu")
    trees = conv.moco_state_dict_to_params(port.state_dict())
    sched = lambda c: 1e-3 * (1.0 + c)
    tx = optax.adamw(sched, b1=0.9, b2=0.95, weight_decay=0.1,
                     mask=jpre.wd_mask(trees[0]))
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, _: "patch_embed" in tuple(
            p.key if hasattr(p, "key") else str(p) for p in path), trees[0])
    tx = optax.chain(tx, optax.masked(optax.set_to_zero(), frozen))
    views = [(_varied(8, 224, 10 + 2 * i), _varied(8, 224, 11 + 2 * i))
             for i in range(2)]
    ms = [tsched.cosine_momentum(i, base_m=0.99, total_steps=4)
          for i in range(2)]
    ref = _jax_moco_steps("vit_b", trees, tx, views, ms, jnp.float32)

    pe0 = [p.detach().clone() for p in port.patch_embed_parameters()]
    opt = make_adamw(port.trained_parameters(), 0.0, b1=0.9, b2=0.95,
                     weight_decay=0.1, decay_mask=wd_mask)
    step = tmoco.make_moco_train_step(T, sched, stop_grad_patch_embed=True)
    launches = da.attention_fwd.launches
    _port_steps_match(port, opt, "adamw", step, views, ms, ref, REL,
                      lambda i, g: 1e-3 * sched(i), adam_lr=sched)
    assert da.attention_fwd.launches == launches
    mom_pe = port.momentum_encoder.backbone.patch_embed.parameters()
    for a, b, c in zip(port.patch_embed_parameters(), pe0, mom_pe):
        assert torch.equal(a, b) and torch.equal(c, b)


def test_two_rn50_steps_match_jax(monkeypatch):
    """Two MoCo v3 steps of a ResNet-50 with one block a stage (B = 8 at 64
    px, LARS with weight decay 1.5e-6 on a schedule of its own count, the
    2-layer projector), the port in float32 against JAX in float64, each
    step from the state JAX started it from (`_port_steps_match`: 1e-4,
    and each update within 1e-3 of lr times the largest gradient of all:
    LARS passes a bias's or BatchNorm's gradient on unscaled at lr 0.3 to
    0.6, and this net's float32 gradients are ill-conditioned: the port's
    differ from JAX's float64 by up to 9e-4 of the largest gradient, JAX's
    own float32 by up to 2.1e-3); LARS's count at 2."""
    monkeypatch.setattr(jmoco, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    port = tmoco.MoCo("resnet50", DIM, MLP_DIM, stage_sizes=TINY,
                      device="cpu")
    trees = conv.moco_state_dict_to_params(port.state_dict())
    sched = lambda c: 0.3 * (1.0 + c)
    views = [(_varied(8, 64, 20 + 2 * i), _varied(8, 64, 21 + 2 * i))
             for i in range(2)]
    ms = [tsched.cosine_momentum(i, base_m=0.99, total_steps=4)
          for i in range(2)]
    with jax.enable_x64(True):
        ref = _jax_moco_steps("resnet50", trees,
                              jlars.lars(sched, weight_decay=1.5e-6), views,
                              ms, jnp.float64)
    opt = LARS(port.trained_parameters(), lr=sched, weight_decay=1.5e-6)
    step = tmoco.make_moco_train_step(T, None)
    _port_steps_match(port, opt, "lars", step, views, ms, ref, 1e-4,
                      lambda i, g: 1e-3 * sched(i) * g)
    assert opt.param_groups[0]["count"] == 2
