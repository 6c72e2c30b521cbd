"""The detection slice of the port (`ssl4gie_tpu_torch/models/vit.py` det
mode, `vitdet_fpn.py`, `faster_rcnn.py`, `tasks/detection.py`,
`convert/from_jax.py`) against the JAX package's, in float32 on the CPU,
from one weight set and, for the samplers, the same noise: the key flax
hands the model is recovered (`make_rng("sampler")`) and its splits
(`faster_rcnn.py:158-167`, `rpn.py:128`, `roi_heads.py:65-72`) replayed into
the port's noise tensors.

The full-width ViT-B `FasterRCNN` runs at 256 px, B = 2, with the reduced
proposal counts of `tests/test_detection.py:252-255`; its JAX side is
computed once (module fixture): one `value_and_grad`, one train step with
two microbatches and one eval. Its weights are the port's random init,
converted to the JAX tree (a JAX init of ViT-B costs most of a minute on one
core)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from ssl4gie_tpu.models.rpn import select_proposals as jax_select_proposals
from ssl4gie_tpu.tasks import detection as jdet
from ssl4gie_tpu_torch.convert.from_jax import (
    faster_rcnn_params_to_torch, faster_rcnn_state_dict_to_params,
    vit_det_backbone_params_to_torch, vitdet_fpn_params_to_torch)
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.models.faster_rcnn import STRIDES, FasterRCNN
from ssl4gie_tpu_torch.models.rpn import select_proposals
from ssl4gie_tpu_torch.tasks import detection as tdet

torch.set_num_threads(1)

B, SIZE, LR = 2, 256, 1e-4
KW = dict(rpn_pre_nms_top_n_train=200, rpn_pre_nms_top_n_test=100,
          rpn_post_nms_top_n_train=100, rpn_post_nms_top_n_test=50,
          box_batch_size_per_image=64, detections_per_img=10)
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-3
T = torch.from_numpy
J = jnp.asarray


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_noise(model, params, key, batch: int, n_anchors: int, n_props: int):
    """The uniform noise the JAX FasterRCNN's train forward draws from the
    sampler key `key`, as the port's noise dict."""
    k = model.apply({"params": params}, rngs={"sampler": key},
                    method=lambda m: m.make_rng("sampler"))
    rpn = [jax.random.uniform(ki, (n_anchors,))
           for ki in jax.random.split(k, batch)]
    samp, tie = [], []
    for ki in jax.random.split(jax.random.fold_in(k, 1), batch):
        ks, kt = jax.random.split(ki)
        samp.append(jax.random.uniform(ks, (n_props,)))
        tie.append(jax.random.uniform(kt, (n_props,)))
    return {name: T(np.stack([np.asarray(a) for a in arrs]))
            for name, arrs in (("rpn", rpn), ("roi_sample", samp),
                               ("roi_tie", tie))}


def _batch():
    samples = [jdet.SyntheticDetectionSource(4, canvas=SIZE).get(i)
               for i in range(B)]
    b = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    b["image"] = b["image"].astype(np.float32) / 255.0
    return b


@pytest.fixture(scope="module")
def full():
    """Weights, batch, noise and the JAX package's losses, gradients,
    proposals, train step (accum 2) and eval at them."""
    tmodel = FasterRCNN(image_size=SIZE, device="cpu", **KW)
    sd0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    params = jax.tree_util.tree_map(J, faster_rcnn_state_dict_to_params(sd0))
    jmodel = JaxFasterRCNN(arch="vit_b", image_size=SIZE, **KW)
    batch = _batch()
    jb = {k: J(v) for k, v in batch.items()}
    shapes = tmodel.noise_shapes(B)
    n_anchors, n_props = shapes["rpn"][1], shapes["roi_sample"][1]
    key = jax.random.PRNGKey(1)

    def loss_fn(p, b, k):
        losses, st = jmodel.apply(
            {"params": p}, b["image"], b["gt_boxes"], b["gt_labels"],
            b["gt_valid"], train=True, rngs={"sampler": k},
            capture_intermediates=lambda m, _: m.name == "rpn_head",
            mutable=["intermediates"])
        obj, dl = st["intermediates"]["rpn_head"]["__call__"][0]
        return sum(losses.values()), (losses, obj, dl)

    (total, (losses, obj, dl)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jb, key)
    tx = jax_make_adamw(LR)
    upd, _ = tx.update(grads, tx.init(params), params)
    step1 = optax.apply_updates(params, upd)

    step2_fn = jdet.make_detection_train_step(jmodel, tx, accum_steps=2,
                                              top_level=False)
    (step2, opt2), m2 = step2_fn((jax.tree_util.tree_map(jnp.array, params),
                                  tx.init(params)), jb, key)
    micro_keys = jax.random.split(key, 2)
    det = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))(
        params, jb["image"])

    anchors = J(tmodel_anchors(tmodel))
    sizes = [(SIZE // s) ** 2 * 3 for s in STRIDES]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    slices = [(offs[i], offs[i + 1]) for i in range(len(sizes))]
    prop_fn = functools.partial(
        jax_select_proposals, anchors=anchors, level_ids=None,
        level_slices=slices, image_size=SIZE, pre_nms_top_n=200,
        post_nms_top_n=100, nms_thresh=0.7)
    props, pvalid = jax.vmap(lambda o, d: prop_fn(o, d))(obj, dl)
    return {
        "sd0": sd0, "batch": batch, "slices": slices,
        "noise": jax_noise(jmodel, params, key, B, n_anchors, n_props),
        "micro_noise": [jax_noise(jmodel, params, k, 1, n_anchors, n_props)
                        for k in micro_keys],
        "total": float(total), "losses": {k: float(v) for k, v in
                                          losses.items()},
        "grads": faster_rcnn_params_to_torch(_np_tree(grads)),
        "obj": np.asarray(obj), "deltas": np.asarray(dl),
        "proposals": np.asarray(props), "prop_valid": np.asarray(pvalid),
        "step1": faster_rcnn_params_to_torch(_np_tree(step1)),
        "step2": faster_rcnn_params_to_torch(_np_tree(step2)),
        # Adam's first step: mu = (1 - b1) g, the step's averaged gradient
        "grads2": faster_rcnn_params_to_torch(jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1, _adam_mu(opt2))),
        "loss2": float(m2["loss"]), "det": _np_tree(det)}


def tmodel_anchors(tmodel):
    from ssl4gie_tpu_torch.models.rpn import generate_anchors
    return generate_anchors([(SIZE // s, SIZE // s) for s in STRIDES],
                            STRIDES)


def _port(full):
    model = FasterRCNN(image_size=SIZE, device="cpu", **KW)
    model.load_state_dict(full["sd0"])
    return model


def _port_batch(full):
    return {k: T(v) for k, v in full["batch"].items()}


def _adam_mu(opt_state):
    """The first moment tree inside the optax chain state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no adam state found")


def _check_grads(named, ref_grads):
    """Every gradient element within GRAD_TOL of the largest gradient
    element of the model. (Relative to each tensor's own largest element
    the error reaches 0.8%, on pos_embed: the RoIAlign taps floor sample
    points that the two packages compute a rounding apart, so a few
    feature-gradient contributions land on the neighbouring cell.)"""
    gmax = max(r.abs().max().item() for r in ref_grads.values())
    for name, p in named.items():
        err = (p.grad - ref_grads[name]).abs().max().item()
        assert err <= GRAD_TOL * gmax, (name, err, gmax)


def _check_step(model, ref_params, ref_grads, lr=LR):
    """The gradients the step applied (p.grad) and the AdamW update. Adam's
    first update moves each element by about lr * sign(g): an element whose
    gradient is within rounding of zero can take the other sign in the two
    packages, so every element is bounded by 2 lr, and those whose reference
    gradient is at least 5% of its tensor's largest must agree within 1e-6."""
    named = dict(model.named_parameters())
    assert set(named) == set(ref_params) == set(ref_grads)
    _check_grads(named, ref_grads)
    for name, p in named.items():
        diff = (p.detach() - ref_params[name]).abs()
        g = ref_grads[name].abs()
        assert diff.max().item() <= 2 * lr * (1 + 1e-3), name
        clear = g >= 5e-2 * g.max()
        assert diff[clear].max().item() <= 1e-6, name


def test_train_step_losses_gradients_and_proposals_match_jax(full):
    """One f32 train step (accum 1) at the JAX noise: the RPN outputs, the
    proposals (indices and validity exactly), the four losses (1e-4
    relative), every gradient (1e-3 of the largest gradient element) and the
    AdamW update."""
    model = _port(full)
    captured = {}
    model.rpn.head.register_forward_hook(
        lambda m, i, o: captured.setdefault("rpn", o))
    opt = make_adamw(model.parameters(), LR)
    out = tdet.make_detection_train_step(1)(model, opt, _port_batch(full),
                                            noise=[full["noise"]])

    obj, dl = (t.detach() for t in captured["rpn"])
    np.testing.assert_allclose(obj.numpy(), full["obj"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dl.numpy(), full["deltas"], rtol=1e-4,
                               atol=1e-4)
    anchors = T(tmodel_anchors(model))
    args = (anchors, full["slices"], SIZE, 200, 100, 0.7)
    props, ok, idx = select_proposals(obj, dl, *args, return_index=True)
    _, ok_j, idx_j = select_proposals(T(full["obj"]), T(full["deltas"]), *args,
                                      return_index=True)
    np.testing.assert_array_equal(ok.numpy(), full["prop_valid"])
    np.testing.assert_array_equal(ok_j.numpy(), full["prop_valid"])
    np.testing.assert_array_equal(idx.numpy(), idx_j.numpy())
    np.testing.assert_allclose(props.numpy(), full["proposals"], rtol=1e-5,
                               atol=1e-3)

    for name, ref in full["losses"].items():
        np.testing.assert_allclose(out[name].item(), ref, rtol=LOSS_RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(out["loss"].item(), full["total"],
                               rtol=LOSS_RTOL)
    _check_step(model, full["step1"], full["grads"])


def test_train_step_with_two_microbatches_matches_jax(full):
    """`accum_steps=2`: each microbatch with the noise of its own split key,
    the gradients averaged; the loss and the AdamW update against the JAX
    package's scanned step."""
    model = _port(full)
    opt = make_adamw(model.parameters(), LR)
    out = tdet.make_detection_train_step(2)(model, opt, _port_batch(full),
                                            noise=full["micro_noise"])
    np.testing.assert_allclose(out["loss"].item(), full["loss2"],
                               rtol=LOSS_RTOL)
    _check_step(model, full["step2"], full["grads2"])


def test_eval_detections_match_jax(full):
    model = _port(full).eval()
    with torch.no_grad():
        det = model(T(full["batch"]["image"]))
    ref = full["det"]
    assert {k: tuple(v.shape) for k, v in det.items()} == \
        {"boxes": (B, 10, 4), "scores": (B, 10), "labels": (B, 10),
         "valid": (B, 10)}
    np.testing.assert_array_equal(det["valid"].numpy(), ref["valid"])
    v = ref["valid"]
    assert v.any()
    np.testing.assert_array_equal(det["labels"].numpy()[v], ref["labels"][v])
    np.testing.assert_allclose(det["scores"].numpy()[v], ref["scores"][v],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy()[v], ref["boxes"][v],
                               rtol=1e-4, atol=1e-2)


def test_det_backbone_forward_and_backward_match_jax():
    """Det-mode ViTBackbone at 512 px, depth 3, width 128, 2 heads (Dh 64):
    a 32x32 grid, 4 windows per image in blocks 0 and 1, and 1024 global
    tokens in block 2 (the flash route); output and input/param gradients
    2e-4."""
    from ssl4gie_tpu.models.vit import ViTBackbone as JaxViTBackbone
    from ssl4gie_tpu_torch.models.vit import ViTBackbone
    cfg = dict(img_size=512, mode="det", depth=3, embed_dim=128, num_heads=2)
    jm = JaxViTBackbone(**cfg)
    x = np.random.default_rng(0).normal(0, 1, (2, 512, 512, 3)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(0), J(x[:1]))["params"]

    def loss(p, x):
        o = jm.apply({"params": p}, x)
        return jnp.sum(o * jnp.sin(o)), o

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, J(x))
    tm = ViTBackbone(**cfg)
    assert not hasattr(tm, "cls_token")
    tm.load_state_dict(vit_det_backbone_params_to_torch(_np_tree(params)))
    xt = T(x).requires_grad_(True)
    out = tm(xt)
    assert out.shape == (2, 32, 32, 128)
    torch.sum(out * torch.sin(out)).backward()
    _close_to_max(out.detach(), np.asarray(ref), 2e-4, "out")
    _close_to_max(xt.grad, np.asarray(gx), 2e-4, "x")
    ref_g = vit_det_backbone_params_to_torch(_np_tree(gp))
    for name, p in tm.named_parameters():
        _close_to_max(p.grad, ref_g[name].numpy(), 2e-4, name)


def _close_to_max(got, ref, tol, name):
    """Every element within tol of the reference's largest element (the
    gradients of sum(o sin o) reach the hundreds)."""
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (name, err)


@pytest.mark.parametrize("ln_mode", ["channel", "chw"])
def test_vitdet_fpn_matches_jax(ln_mode):
    """Both LayerNorm modes, 1e-5: the deconvolutions only agree because the
    converter flips flax's ConvTranspose kernel in both spatial axes."""
    from ssl4gie_tpu.models.vitdet_fpn import ViTDetFPN as JaxViTDetFPN
    from ssl4gie_tpu_torch.models.vitdet_fpn import ViTDetFPN
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    jm = JaxViTDetFPN(out_channels=16, ln_mode=ln_mode)
    params = _np_tree(jm.init(jax.random.PRNGKey(2), J(x))["params"])
    # non-trivial LayerNorm affines, so a transposed (H, W, C) map shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if "ln" in str(path) else a, params)
    ref = jm.apply({"params": params}, J(x))
    tm = ViTDetFPN(32, 16, ln_mode=ln_mode, grid=8)
    tm.load_state_dict(vitdet_fpn_params_to_torch(params))
    with torch.no_grad():
        out = tm(T(x))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_deconv_flip_is_what_flax_computes():
    """A unit impulse through flax's ConvTranspose(1, (2, 2), strides 2)
    returns its 2x2 kernel flipped in both axes; the converted port layer
    returns it as flax does."""
    import flax.linen as nn
    from ssl4gie_tpu_torch.models.vitdet_fpn import deconv2x_nhwc
    k = np.arange(1.0, 5.0, dtype=np.float32).reshape(2, 2, 1, 1)
    ref = nn.ConvTranspose(1, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": J(k), "bias": J(np.zeros(1, np.float32))}},
        J(np.ones((1, 1, 1, 1), np.float32)))
    np.testing.assert_array_equal(np.asarray(ref)[0, :, :, 0],
                                  k[::-1, ::-1, 0, 0])
    dc = torch.nn.ConvTranspose2d(1, 1, 2, stride=2)
    sd = vitdet_fpn_params_to_torch(_fpn_tree_with(k))
    with torch.no_grad():
        dc.weight.copy_(sd["fpn3_deconv.weight"])
        dc.bias.zero_()
        out = deconv2x_nhwc(torch.ones(1, 1, 1, 1), dc, torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _fpn_tree_with(k):
    """A ViTDetFPN param tree of 1-channel layers, `k` as every deconv."""
    z = lambda *s: np.zeros(s, np.float32)
    conv = lambda kh: {"kernel": z(kh, kh, 1, 1), "bias": z(1)}
    ln = {"scale": z(1) + 1, "bias": z(1)}
    tree = {f"fpn{i}": {"proj": conv(1), "ln1": ln, "conv": conv(3),
                        "ln2": ln} for i in range(1, 5)}
    for d in ("fpn3_deconv", "fpn4_deconv1", "fpn4_deconv2"):
        tree[d] = {"kernel": k, "bias": z(1)}
    tree["fpn4_ln"] = ln
    return tree


def test_param_count_and_converter_round_trip_match_jax():
    """The port's FasterRCNN(vit_b) has the JAX tree's parameters, one for
    one (no cls_token in det mode), and the converter's two directions are
    exact inverses on a random tree of the JAX shapes."""
    jmodel = JaxFasterRCNN(arch="vit_b", image_size=SIZE, **KW)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    shapes = shapes["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    model = FasterRCNN(image_size=SIZE, device="cpu", **KW)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)
    sd = faster_rcnn_params_to_torch(tree)
    model.load_state_dict(sd)                       # every name, every shape
    back = faster_rcnn_state_dict_to_params(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))


def test_detection_augment_matches_jax():
    """`detection_augment` at the flags and factors the JAX key draws: boxes
    exactly equal, images within the jitter/blur tolerance of
    test_torch_augment (1e-5); the rot90 and flips element-exact against
    numpy's on the image that no flag moved."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    boxes = np.stack([_rand_boxes(rng, 64) for _ in range(4)])
    key = jax.random.PRNGKey(11)
    ref_img, ref_boxes = jdet.detection_augment(key, J(img), J(boxes))
    params = _jax_detection_params(key, 4)
    assert params["rot"].any() and not params["rot"].all()
    out_img, out_boxes = tdet.detection_augment(T(img), T(boxes), params)
    np.testing.assert_array_equal(out_boxes.numpy(), np.asarray(ref_boxes))
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img),
                               rtol=1e-5, atol=1e-5)

    # the geometric part is a permutation: against numpy on the jittered
    # and blurred image that no flag moved
    still = {**params, **{f: torch.zeros(4, dtype=torch.bool)
                          for f in ("rot", "hflip", "vflip")}}
    want = tdet.detection_augment(T(img), T(boxes), still)[0].numpy()
    geo = out_img
    for b in range(4):
        w = want[b]
        if params["rot"][b]:
            w = np.rot90(w, 1, axes=(0, 1))
        if params["hflip"][b]:
            w = w[:, ::-1]
        if params["vflip"][b]:
            w = w[::-1]
        np.testing.assert_array_equal(geo[b].numpy(), w)


def _rand_boxes(rng, size, n=16):
    xy = rng.uniform(0, size * 0.6, (n, 2))
    wh = rng.uniform(2, size * 0.35, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(
        np.float32)


def _jax_detection_params(key, batch):
    """The factors `jdet.detection_augment(key, ...)` draws, replaying its
    key splits, as the port's parameter dict."""
    kj, kb, kr, kh, kv = jax.random.split(key, 5)
    kbr, kc, ks, khue, ko = jax.random.split(kj, 5)
    u = lambda k, shape, lo, hi: T(np.asarray(jax.random.uniform(
        k, shape, minval=lo, maxval=hi)).reshape(batch).copy())
    flag = lambda k: T(np.asarray(jax.random.uniform(k, (batch,)) > 0.5))
    return {"brightness": u(kbr, (batch, 1, 1, 1), 0.6, 1.4),
            "contrast": u(kc, (batch, 1, 1, 1), 0.5, 1.5),
            "saturation": u(ks, (batch, 1, 1, 1), 0.75, 1.25),
            "hue": u(khue, (batch, 1, 1), -0.01, 0.01),
            "order": np.asarray(jax.random.permutation(ko, 4)).tolist(),
            "sigma": u(kb, (batch, 1), 0.001, 2.0),
            "rot": flag(kr), "hflip": flag(kh), "vflip": flag(kv)}


def test_synthetic_source_and_sampler():
    """The synthetic source gives the JAX package's arrays; the port's
    detection sampler has the JAX ranges (flags about half set)."""
    for i in range(3):
        a = tdet.SyntheticDetectionSource(4, canvas=96, seed=2).get(i)
        r = jdet.SyntheticDetectionSource(4, canvas=96, seed=2).get(i)
        for k in r:
            np.testing.assert_array_equal(a[k], r[k])
    p = tdet.sample_detection_params(4096, torch.Generator().manual_seed(0))
    for name in ("rot", "hflip", "vflip"):
        assert p[name].dtype == torch.bool
        assert abs(p[name].float().mean().item() - 0.5) < 0.03
    assert 0.001 <= p["sigma"].min() and p["sigma"].max() <= 2.0
    assert sorted(p["order"]) == [0, 1, 2, 3]

