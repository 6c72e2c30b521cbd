"""The RN50 detector and the detection evaluation of the port
(`ssl4gie_tpu_torch/models/vitdet_fpn.py:ResNetFPN`,
`models/faster_rcnn.py` with `arch="resnet50"` and `content_sizes`, the
anchor mask and per-image clips of `models/rpn.py` and
`models/roi_heads.py`, `metrics/detection.py`, `data/discovery.py`,
`tasks/detection.py`'s source, clips and `evaluate_map`, and the RN50
detector's converter) against the JAX package's, in float32 on the CPU,
from one weight set and, for the samplers, the same noise (the replay of
`tests/test_torch_detection.py`).

The JAX `ResNetFPN` has no depth knob, so the RN50 is full depth, at a 96
px canvas (64 px for the tight side of the cross-canvas check), B = 2, with
the reduced proposal counts of `tests/test_detection.py:583-586`. The
weights are the port's init with random biases and BatchNorm statistics,
each block's last BatchNorm scale cut to 0.3 of its draw (otherwise the 16
residual sums of the body reach activations in the hundreds and saturate
the box head's softmax, and no detection passes the score threshold),
handed to JAX by the inverse converter. The body's BatchNorms keep their
running statistics in training, so the train step holds in float32. JAX
is jitted (at these sizes compiling is quicker than running op by op) at
XLA's backend optimization level 0, which compiles the detector's gradient
in 19 s on one core instead of 32 and moves its float results by a
rounding."""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.data import discovery as jdisc
from ssl4gie_tpu.metrics import detection as jmetric
from ssl4gie_tpu.models import roi_heads as jroi
from ssl4gie_tpu.models import rpn as jrpn
from ssl4gie_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from ssl4gie_tpu.models.vitdet_fpn import ResNetFPN as JaxResNetFPN
from ssl4gie_tpu.tasks import detection as jdet
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.data import discovery as tdisc
from ssl4gie_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from ssl4gie_tpu_torch.metrics import detection as tmetric
from ssl4gie_tpu_torch.models import roi_heads as troi
from ssl4gie_tpu_torch.models import rpn as trpn
from ssl4gie_tpu_torch.models.faster_rcnn import (STRIDES, FasterRCNN,
                                                  _anchor_lattice,
                                                  level_shapes)
from ssl4gie_tpu_torch.models.resnet import Bottleneck, extent_mask
from ssl4gie_tpu_torch.tasks import detection as tdet
from test_torch_detection import _check_step, jax_noise
from test_torch_resnet import randomized

torch.set_num_threads(1)

B, S, LR = 2, 96, 1e-4
KW = dict(rpn_pre_nms_top_n_train=200, rpn_pre_nms_top_n_test=100,
          rpn_post_nms_top_n_train=100, rpn_post_nms_top_n_test=50,
          box_batch_size_per_image=64, detections_per_img=10)
LOSS_RTOL = 1e-4
SMALL = [[64, 50], [40, 60]]     # extents whose batch max (64, 64) < S
T = torch.from_numpy
J = jnp.asarray
jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@torch.no_grad()
def conditioned(model: FasterRCNN) -> FasterRCNN:
    """`randomized` weights with each bottleneck's last BatchNorm scale cut
    to 0.3 of its draw (see the module docstring)."""
    randomized(model)
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.bn3.weight.mul_(0.3)
    return model


def port_model(sd, image_size=S, **kw) -> FasterRCNN:
    model = FasterRCNN(arch="resnet50", image_size=image_size, device="cpu",
                       **{**KW, **kw})
    model.load_state_dict(sd)
    return model


def jax_model(image_size=S, **kw) -> JaxFasterRCNN:
    return JaxFasterRCNN(arch="resnet50", image_size=image_size,
                         **{**KW, **kw})


def _batch(canvas=S, seed=0):
    src = jdet.SyntheticDetectionSource(4, canvas=canvas, seed=seed)
    b = {k: np.stack([src.get(i)[k] for i in range(B)])
         for k in src.get(0)}
    b["image"] = b["image"].astype(np.float32) / 255.0
    return b


@pytest.fixture(scope="module")
def weights():
    """The port's state_dict and the JAX variables made from it."""
    model = conditioned(FasterRCNN(arch="resnet50", image_size=S,
                                   device="cpu", **KW))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats = conv.faster_rcnn_rn50_state_dict_to_params(sd)
    variables = {"params": jax.tree_util.tree_map(J, params),
                 "batch_stats": jax.tree_util.tree_map(J, stats)}
    return sd, variables


def _torch_params(variables, tree=None):
    """A JAX params tree (the model's, or `tree` of its shape) as the
    port's parameter names (no running statistics)."""
    sd = conv.faster_rcnn_rn50_params_to_torch(
        _np_tree(variables["params"] if tree is None else tree),
        _np_tree(variables["batch_stats"]))
    return {k: v for k, v in sd.items() if "running_" not in k}


@pytest.fixture(scope="module")
def jax_train(weights):
    """The JAX package's losses, gradients, FPN maps, RPN outputs,
    proposals and train steps (accum 1 and 2) at the weights and the
    sampler key 1."""
    _, variables = weights
    params, stats = variables["params"], variables["batch_stats"]
    jm = jax_model()
    batch = _batch()
    jb = {k: J(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    shapes = port_model(weights[0]).noise_shapes(B)
    n_anchors, n_props = shapes["rpn"][1], shapes["roi_sample"][1]

    def loss_fn(p, b, k):
        losses, st = jm.apply(
            {"params": p, "batch_stats": stats}, b["image"], b["gt_boxes"],
            b["gt_labels"], b["gt_valid"], train=True, rngs={"sampler": k},
            capture_intermediates=lambda m, _: m.name in ("rpn_head",
                                                         "backbone"),
            mutable=["intermediates"])
        st = st["intermediates"]
        obj, dl = st["rpn_head"]["__call__"][0]
        return sum(losses.values()), (losses, obj, dl,
                                      st["backbone"]["__call__"][0])

    value_and_grad = jit(jax.value_and_grad(loss_fn, has_aux=True))
    (total, (losses, obj, dl, maps)), grads = value_and_grad(params, jb, key)
    tx = jax_make_adamw(LR)
    adamw = jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))
    # two microbatches as the scan of `make_detection_train_step(
    # accum_steps=2)` takes them, written out (compiling the package's
    # scanned step costs 50 s here; test_torch_detection.py holds the
    # port's accumulation against it): each microbatch with its split key,
    # the gradients and losses summed in order and halved
    micro = [value_and_grad(params, {n: v[i:i + 1] for n, v in jb.items()},
                            k)
             for i, k in enumerate(jax.random.split(key, 2))]
    grads2 = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                    micro[0][1], micro[1][1])

    anchors, slices, _ = _anchor_lattice(level_shapes(S), torch.device("cpu"))
    props, pvalid = jit(jax.vmap(lambda o, d: jrpn.select_proposals(
        o, d, anchors=J(anchors.numpy()), level_ids=None, level_slices=slices,
        image_size=S, pre_nms_top_n=200, post_nms_top_n=100,
        nms_thresh=0.7)))(obj, dl)
    return {
        "batch": batch, "slices": slices, "anchors": anchors,
        "noise": jax_noise(jm, params, key, B, n_anchors, n_props),
        "micro_noise": [jax_noise(jm, params, k, 1, n_anchors, n_props)
                        for k in jax.random.split(key, 2)],
        "total": float(total),
        "losses": {k: float(v) for k, v in losses.items()},
        "grads": _torch_params(variables, grads),
        "obj": np.asarray(obj), "deltas": np.asarray(dl),
        "maps": [np.asarray(m) for m in maps],
        "proposals": np.asarray(props), "prop_valid": np.asarray(pvalid),
        "step1": _torch_params(variables, adamw(grads, params)),
        "step2": _torch_params(variables, adamw(grads2, params)),
        "grads2": _torch_params(variables, grads2),
        "loss2": float((micro[0][0][0] + micro[1][0][0]) / 2)}


def _stats(sd):
    return {k: v for k, v in sd.items() if "running_" in k}


def test_train_step_matches_jax_and_keeps_running_statistics(weights,
                                                             jax_train):
    """One f32 train step (accum 1) at the JAX noise: the five FPN maps
    (the `ResNetFPN` forward without an extent, 2e-4 of their largest
    element), the RPN outputs, the proposals (indices and validity
    exactly), the four losses (1e-4 relative), every gradient, the
    backbone's (its backward) and the body's BatchNorm scales and biases
    among them (1e-3 of the largest gradient element), and the AdamW
    update; the running statistics are bitwise unchanged."""
    sd, _ = weights
    ref = jax_train
    model = port_model(sd)
    captured = {}
    model.rpn.head.register_forward_hook(
        lambda m, i, o: captured.setdefault("rpn", o))
    model.backbone.register_forward_hook(
        lambda m, i, o: captured.setdefault("maps", o))
    opt = make_adamw(model.parameters(), LR)
    out = tdet.make_detection_train_step(1)(
        model, opt, {k: T(v) for k, v in ref["batch"].items()},
        noise=[ref["noise"]])
    assert model.backbone.body.training is False
    assert model.backbone.fpn.training and model.rpn.training
    for o, r in zip(captured["maps"], ref["maps"]):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                   atol=2e-4 * np.abs(r).max())

    obj, dl = (t.detach() for t in captured["rpn"])
    np.testing.assert_allclose(obj.numpy(), ref["obj"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dl.numpy(), ref["deltas"], rtol=1e-4,
                               atol=1e-4)
    args = (ref["anchors"], ref["slices"], S, 200, 100, 0.7)
    props, ok, idx = trpn.select_proposals(obj, dl, *args, return_index=True)
    _, ok_j, idx_j = trpn.select_proposals(T(ref["obj"]), T(ref["deltas"]),
                                           *args, return_index=True)
    np.testing.assert_array_equal(ok.numpy(), ref["prop_valid"])
    np.testing.assert_array_equal(ok_j.numpy(), ref["prop_valid"])
    np.testing.assert_array_equal(idx.numpy(), idx_j.numpy())
    np.testing.assert_allclose(props.numpy(), ref["proposals"], rtol=1e-5,
                               atol=1e-3)

    for name, want in ref["losses"].items():
        np.testing.assert_allclose(out[name].item(), want, rtol=LOSS_RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(out["loss"].item(), ref["total"],
                               rtol=LOSS_RTOL)
    assert "backbone.body.layer1.0.bn3.weight" in dict(
        model.named_parameters())
    _check_step(model, ref["step1"], ref["grads"])
    after = model.state_dict()
    for k, v in _stats(sd).items():
        assert torch.equal(after[k], v), k


def test_train_step_with_two_microbatches_matches_jax(weights, jax_train):
    """`accum_steps=2`, each microbatch with the noise of its own split key:
    the loss, the averaged gradients and the AdamW update against JAX's;
    the running statistics are bitwise unchanged."""
    sd, _ = weights
    model = port_model(sd)
    opt = make_adamw(model.parameters(), LR)
    out = tdet.make_detection_train_step(2)(
        model, opt, {k: T(v) for k, v in jax_train["batch"].items()},
        noise=jax_train["micro_noise"])
    np.testing.assert_allclose(out["loss"].item(), jax_train["loss2"],
                               rtol=LOSS_RTOL)
    _check_step(model, jax_train["step2"], jax_train["grads2"])
    after = model.state_dict()
    for k, v in _stats(sd).items():
        assert torch.equal(after[k], v), k


def test_backbone_forward_under_train_equals_eval(weights):
    """`model.train()` leaves the body's BatchNorms on their running
    statistics: the FPN maps under train() equal those under eval()
    bitwise, and a forward in train mode moves no statistic."""
    sd, _ = weights
    model = port_model(sd)
    x = T(_batch()["image"])
    with torch.no_grad():
        model.train()
        got = model.backbone(x)
        model.eval()
        want = model.backbone(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    after = model.state_dict()
    for k, v in _stats(sd).items():
        assert torch.equal(after[k], v), k


def test_resnet_fpn_with_extent_forward_and_backward_match_jax(weights):
    """`ResNetFPN` at 96 px, B = 2, with a (64, 32) extent (without one it
    is held inside the train step's test): the five levels 2e-4 of their
    largest element, zero beyond the extent; the gradients of a random
    linear function of the levels, the input's and every parameter's,
    1e-3 of their largest element."""
    sd, variables = weights
    model = port_model(sd).backbone
    mask_hw = (64, 32)
    jvars = {"params": variables["params"]["backbone"],
             "batch_stats": variables["batch_stats"]["backbone"]}
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    sizes = [(h, h) for h, _ in level_shapes(S)]
    ws = [rng.normal(0, 1, (B, h, w, 256)).astype(np.float32)
          for h, w in sizes]

    def jloss(p, x):
        outs = JaxResNetFPN().apply(
            {"params": p, "batch_stats": jvars["batch_stats"]}, x,
            train=False, mask_hw=mask_hw)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    (_, ref), (gp, gx) = jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jvars["params"], J(x))
    xt = T(x).requires_grad_(True)
    outs = model(xt, mask_hw=mask_hw)
    sum(torch.sum(o * T(w)) for o, w in zip(outs, ws)).backward()
    for o, r, s in zip(outs, ref, STRIDES):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                   atol=2e-4 * np.abs(r).max())
        h, w = -(-mask_hw[0] // s), -(-mask_hw[1] // s)
        assert not o[:, h:].any() and not o[:, :, w:].any()
    _grad_close(xt.grad, np.asarray(gx), "x")
    ref_g = _torch_params(
        variables, {**variables["params"], "backbone": gp})
    for name, p in model.named_parameters():
        _grad_close(p.grad, ref_g["backbone." + name].numpy(), name)


def _grad_close(got, ref, name, tol=1e-3):
    err = np.abs(got.numpy() - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (name, err)


# --------------------------------------------------------------- eval

def _jax_eval_fns(jm):
    """Jitted JAX eval without and with content sizes, each returning the
    detections and the box head's outputs for every proposal; the second
    also returns what the body's stem convolution reads (its masked,
    normalized input)."""

    def apply(v, x, cs=None):
        det, st = jm.apply(
            v, x, train=False, content_sizes=cs,
            capture_intermediates=lambda m, _: m.name == "box_head",
            mutable=["intermediates"])
        return det, st["intermediates"]["box_head"]["__call__"][0]

    def with_sizes(v, x, cs):
        seen = {}

        def icpt(next_fun, args, kwargs, context):
            if context.module.path == ("backbone", "body", "conv1"):
                seen["stem_in"] = args[0]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(icpt):
            det, head = apply(v, x, cs)
        return det, head, seen["stem_in"]

    return jit(apply), jit(with_sizes)


@pytest.fixture(scope="module")
def jax_eval(weights):
    """The JAX detections, box-head outputs and (with content sizes) stem
    inputs at the eval batch: content_sizes None, the full canvas, SMALL,
    and 50 x 38 on the band images."""
    _, variables = weights
    plain, with_sizes = _jax_eval_fns(jax_model())
    x = J(_batch()["image"])
    out = {"none": _np_tree(plain(variables, x)) + (None,)}
    for name, cs, xs in (("full", [[S, S]] * B, x), ("small", SMALL, x),
                         ("band", [[50, 38]] * B, J(band_images()))):
        out[name] = _np_tree(with_sizes(variables, xs,
                                        J(np.asarray(cs, np.int32))))
    return out


CASES = {"none": None, "full": [[S, S]] * B, "small": SMALL}


def band_images():
    """The eval batch cut to 50 x 38 content, top-left on the canvas."""
    images = _batch()["image"]
    images[:, 38:] = 0.0
    images[:, :, 50:] = 0.0
    return images


def assert_detections_close(det, ref):
    """Validity and labels exactly, scores 1e-4 relative / 1e-5 absolute,
    boxes 1e-2 px, on the valid slots."""
    det = {k: np.asarray(v) for k, v in det.items()}
    np.testing.assert_array_equal(det["valid"], ref["valid"])
    v = ref["valid"].astype(bool)
    assert v.any(), "degenerate comparison: no detections"
    np.testing.assert_array_equal(det["labels"][v], ref["labels"][v])
    np.testing.assert_allclose(det["scores"][v], ref["scores"][v],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(det["boxes"][v], ref["boxes"][v], rtol=1e-4,
                               atol=1e-2)


def _port_eval(model, images, cs=None):
    return tdet.make_detection_eval_step(model)(
        T(images), None if cs is None else torch.tensor(cs,
                                                        dtype=torch.int32))


def eval_with_head(model, images, cs=None):
    """The port's detections and its box head's outputs for every
    proposal (these move with the proposals, which the detections alone
    may not show)."""
    seen = []
    hook = model.roi_heads.register_forward_hook(
        lambda m, i, o: seen.append(o))
    det = _port_eval(model, images, cs)
    hook.remove()
    return det, seen[0]


def assert_head_close(head, ref):
    """Class logits and box deltas for every proposal, 2e-4 of their
    largest element."""
    for got, want in zip(head, ref):
        want = np.asarray(want).reshape(got.shape)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_eval_detections_match_jax(weights, jax_eval, case):
    """Eval with content_sizes None, the full canvas (bitwise equal to
    None, the emulation degenerate) and extents whose batch max (64 x 64)
    is below the 96 px canvas (anchor mask, masked backbone, RoIAlign at
    the extent, per-image clips): the port's detections and its box head's
    outputs for every proposal against JAX; at the small extents every
    detection lies inside its image's extent."""
    sd, _ = weights
    model = port_model(sd)
    images = _batch()["image"]
    det, head = eval_with_head(model, images, CASES[case])
    assert_detections_close(det, jax_eval[case][0])
    assert_head_close(head, jax_eval[case][1])
    if case == "full":
        none = _port_eval(model, images)
        for k in det:
            assert torch.equal(det[k], none[k]), k
    if case == "small":
        for bi, (w, h) in enumerate(SMALL):
            b = det["boxes"][bi][det["valid"][bi]]
            assert (b[:, [0, 2]] <= w).all() and (b[:, [1, 3]] <= h).all()


def test_eval_cross_canvas_matches_the_tight_canvas(weights):
    """The twin of tests/test_detection.py::test_eval_cross_canvas_bitwise:
    eval on a 96 px canvas with content 64 x 64 equals eval on the tight 64
    px canvas, validity and labels exactly, scores 1e-5, boxes 0.05 px."""
    sd, _ = weights
    kw = dict(rpn_pre_nms_top_n_test=50, rpn_post_nms_top_n_test=25,
              box_batch_size_per_image=32, detections_per_img=8,
              box_score_thresh=1e-6)
    xt = _batch(canvas=64, seed=3)["image"]
    xb = np.zeros((B, S, S, 3), np.float32)
    xb[:, :64, :64] = xt
    cs = [[64, 64]] * B
    det_t = _port_eval(port_model(sd, 64, **kw), xt, cs)
    det_b = _port_eval(port_model(sd, S, **kw), xb, cs)
    np.testing.assert_array_equal(det_t["valid"].numpy(),
                                  det_b["valid"].numpy())
    v = det_t["valid"].numpy()
    assert v.any(), "degenerate comparison: no detections"
    np.testing.assert_array_equal(det_t["labels"].numpy()[v],
                                  det_b["labels"].numpy()[v])
    np.testing.assert_allclose(det_t["scores"].numpy()[v],
                               det_b["scores"].numpy()[v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(det_t["boxes"].numpy()[v],
                               det_b["boxes"].numpy()[v], rtol=0, atol=0.05)


def test_extent_band_follows_jax_not_torchvision(weights, jax_eval):
    """The extent band at a 50 x 38 content size: the emulation masks only
    beyond the /32-rounded batch-max extent (64 x 64), so between the
    content and that extent the stem reads the normalized pad, -mean/std,
    where torchvision's post-normalize pad is 0. The port follows the JAX
    package: the same stem input (the band's values included) and the same
    detections."""
    sd, _ = weights
    model = port_model(sd)
    images = band_images()
    seen = {}

    def hook(module, args, kwargs):
        seen["stem_in"] = extent_mask(args[0], kwargs["mask_hw"])

    model.backbone.body.register_forward_pre_hook(hook, with_kwargs=True)
    det, head = eval_with_head(model, images, [[50, 38]] * B)
    ref_det, ref_head, ref_stem = jax_eval["band"]
    assert_detections_close(det, ref_det)
    assert_head_close(head, ref_head)
    stem = seen["stem_in"].numpy()
    np.testing.assert_allclose(stem, ref_stem, rtol=0, atol=1e-6)

    pad = -np.asarray(IMAGENET_MEAN, np.float32) / np.asarray(IMAGENET_STD,
                                                              np.float32)
    band = np.zeros((S, S), bool)
    band[:64, :64] = True
    band[:38, :50] = False
    for got in (stem, ref_stem):
        np.testing.assert_allclose(got[:, band], np.broadcast_to(
            pad, got[:, band].shape), rtol=1e-6)
        assert not got[:, 64:].any() and not got[:, :, 64:].any()
    # torchvision pads after normalizing: 0 in the band
    tv = np.where(np.arange(S)[:, None] < 38, 1, 0) * \
        np.where(np.arange(S)[None, :] < 50, 1, 0)
    tv_stem = ((images - np.asarray(IMAGENET_MEAN, np.float32))
               / np.asarray(IMAGENET_STD, np.float32)) * tv[None, :, :, None]
    assert not tv_stem[:, band].any()


# ------------------------------------------------- proposals and clips

def test_select_proposals_anchor_mask_and_clip_match_jax():
    """The batched `select_proposals` with an anchor mask and per-image
    extents against the JAX function vmapped: proposals and validity
    validity exactly, boxes 1e-3 px. A padded anchor with the highest
    objectness would win the first slot without the mask."""
    shapes, strides = [(8, 8), (4, 4)], [4, 8]
    anchors = jrpn.generate_anchors(shapes, strides)
    grid = jrpn.anchor_grid_info(shapes, strides)
    n = anchors.shape[0]
    av = (grid[:, 0] < 16 // grid[:, 2]) & (grid[:, 1] < 16 // grid[:, 2])
    rng = np.random.default_rng(0)
    obj = rng.normal(-2.0, 0.5, (B, n)).astype(np.float32)
    obj[:, np.flatnonzero(~av)[-5]] = 50.0
    deltas = rng.normal(0, 0.2, (B, n, 4)).astype(np.float32)
    wh = np.asarray([[16, 12], [10, 16]], np.int32)
    slices = [(0, 192), (192, n)]
    kw = dict(image_size=32, pre_nms_top_n=50, post_nms_top_n=10,
              nms_thresh=0.7)
    ref = jit(jax.vmap(lambda o, d, c: jrpn.select_proposals(
        o, d, anchors=J(anchors), level_ids=None, level_slices=slices,
        anchor_valid=J(av), content_wh=c, **kw)))(J(obj), J(deltas), J(wh))
    got = trpn.select_proposals(T(obj), T(deltas), T(anchors), slices,
                                kw["image_size"], kw["pre_nms_top_n"],
                                kw["post_nms_top_n"], kw["nms_thresh"],
                                anchor_valid=T(av), content_wh=T(wh))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-3)
    for bi, (w, h) in enumerate(wh):
        kept = got[0][bi][got[1][bi]].numpy()
        assert len(kept)
        assert kept[:, [0, 2]].max() <= w and kept[:, [1, 3]].max() <= h
    unmasked = trpn.select_proposals(T(obj), T(deltas), T(anchors), slices,
                                     32, 50, 10, 0.7)[0]
    assert not torch.equal(unmasked, got[0])


def test_postprocess_per_image_clip_matches_jax():
    """`postprocess_detections` with per-image extents against the JAX
    function vmapped, at the detection tolerances; every box inside its
    image's extent."""
    rng = np.random.default_rng(1)
    R, K = 40, 3
    scores = rng.normal(0, 2, (B, R, K)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, R, K, 4)).astype(np.float32)
    xy = rng.uniform(0, 60, (B, R, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 40, (B, R, 2))],
                           -1).astype(np.float32)
    pv = rng.random((B, R)) > 0.2
    wh = np.asarray([[50, 30], [64, 45]], np.int32)
    kw = dict(image_size=64, score_thresh=0.05, nms_thresh=0.5,
              detections_per_img=12)
    ref = jit(jax.vmap(lambda s, d, p, v, c: jroi.postprocess_detections(
        s, d, p, v, content_wh=c, **kw)))(J(scores), J(deltas), J(props),
                                          J(pv), J(wh))
    got = troi.postprocess_detections(T(scores), T(deltas), T(props), T(pv),
                                      content_wh=T(wh), **kw)
    assert_detections_close(got, _np_tree(ref))
    for bi, (w, h) in enumerate(wh):
        b = got["boxes"][bi][got["valid"][bi]]
        assert (b[:, [0, 2]] <= w).all() and (b[:, [1, 3]] <= h).all()


# ------------------------------------------------------------ the metric

def _random_dets(rng, n_img, n_cls=3):
    preds, targets = [], []
    for i in range(n_img):
        n_gt = int(rng.integers(0, 5)) if i else 3
        gxy = rng.uniform(0, 80, (n_gt, 2))
        gt = np.concatenate([gxy, gxy + rng.uniform(5, 30, (n_gt, 2))], 1)
        n_p = int(rng.integers(0, 8))
        src = gt[rng.integers(0, max(n_gt, 1), n_p)] if n_gt else \
            rng.uniform(0, 80, (n_p, 4))
        pb = src + rng.normal(0, 3, src.shape)
        # scores drawn from a few values: ties
        preds.append({"boxes": pb.astype(np.float32),
                      "scores": rng.choice([0.3, 0.5, 0.9], n_p).astype(
                          np.float32),
                      "labels": rng.integers(1, n_cls, n_p).astype(np.int32)})
        targets.append({"boxes": gt.astype(np.float32),
                        "labels": rng.integers(1, n_cls, n_gt).astype(
                            np.int32)})
    return preds, targets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mean_average_precision_matches_jax_exactly(seed):
    """`MeanAveragePrecision` on random predictions and targets with tied
    scores, images without targets or predictions, two classes, over two
    updates: the JAX package's map, map_50 and map_75 exactly."""
    rng = np.random.default_rng(seed)
    preds, targets = _random_dets(rng, 7)
    got, ref = tmetric.MeanAveragePrecision(), jmetric.MeanAveragePrecision()
    for m in (got, ref):
        m.update(preds[:3], targets[:3])
        m.update(preds[3:], targets[3:])
    out = got.compute()
    assert set(out) == {"map", "map_50", "map_75"}
    assert out == ref.compute()
    assert np.isfinite(list(out.values())).all()


# ------------------------------------------------------------- the data

def _write_kvasir(root, sizes, seed=0):
    """PNG images of `sizes` (h, w) (the last grayscale) under root/images
    and their boxes in root/bounding-boxes.json; returns the paths and the
    targets as `discover_detection` reads them."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir()
    targets = {}
    for i, (h, w) in enumerate(sizes):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im = Image.fromarray(arr) if i < len(sizes) - 1 else \
            Image.fromarray(arr[..., 0])
        im.save(root / "images" / f"img{i}.png")
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
            boxes.append({"xmin": float(x0), "ymin": float(y0),
                          "xmax": float(min(x0 + rng.uniform(3, 0.4 * w), w)),
                          "ymax": float(min(y0 + rng.uniform(3, 0.4 * h), h))})
        targets[f"img{i}"] = {"bbox": boxes}
    (root / "bounding-boxes.json").write_text(json.dumps(targets))
    paths, tg = tdisc.discover_detection(str(root))
    assert (paths, tg) == jdisc.discover_detection(str(root))
    return paths, tg


@pytest.mark.parametrize("resize,canvas", [("fixed", 1024),
                                           ("torchvision", 1344)])
def test_detection_source_matches_jax(tmp_path, resize, canvas):
    """`DetectionSource` in both modes against the JAX package's on PNGs of
    several sizes (one larger than the fixed canvas with odd sides, one
    grayscale): canvas, boxes, labels, validity, content_size, pad, scale
    and the original image exactly."""
    paths, targets = _write_kvasir(
        tmp_path, [(529, 622), (1081, 1301), (300, 800), (720, 576)])
    got = tdet.DetectionSource(paths, targets, canvas, keep_original=True,
                               resize=resize)
    ref = jdet.DetectionSource(paths, targets, canvas, keep_original=True,
                               resize=resize)
    assert len(got) == len(ref) == 4
    for i in range(4):
        a, r = got.get(i), ref.get(i)
        assert set(a) == set(r)
        assert ("content_size" in a) == (resize == "torchvision")
        for k in r:
            assert a[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(a[k], r[k], err_msg=f"{i} {k}")


def test_clip_to_content_and_boxes_to_original(tmp_path):
    """`clip_to_content` and `boxes_to_original` against the JAX package's
    on random boxes; `boxes_to_original` inverts the placement of the GT
    boxes in both modes (1e-3 px)."""
    rng = np.random.default_rng(2)
    boxes = rng.uniform(-20, 140, (30, 4)).astype(np.float32)
    np.testing.assert_array_equal(tdet.clip_to_content(boxes, (100, 70)),
                                  jdet.clip_to_content(boxes, (100, 70)))
    pad, scale = np.asarray([7, 13]), np.asarray([0.5, 1.25], np.float32)
    np.testing.assert_array_equal(tdet.boxes_to_original(boxes, pad, scale),
                                  jdet.boxes_to_original(boxes, pad, scale))
    paths, targets = _write_kvasir(tmp_path, [(1081, 1301), (300, 800)])
    for resize, canvas in (("fixed", 1024), ("torchvision", 1344)):
        src = tdet.DetectionSource(paths, targets, canvas, True, resize)
        for i, path in enumerate(paths):
            s = src.get(i)
            want, _ = tdet.parse_kvasir_targets(path, targets)
            back = tdet.boxes_to_original(s["gt_boxes"][s["gt_valid"]],
                                          s["pad"], s["scale"])
            np.testing.assert_allclose(back, want, rtol=0, atol=1e-3)


def _record_updates(monkeypatch, cls):
    seen = []
    update = cls.update

    def recording(self, preds, targets):
        seen.append((preds, targets))
        return update(self, preds, targets)

    monkeypatch.setattr(cls, "update", recording)
    return seen


def test_evaluate_map_feeds_the_metric_what_jax_does(weights, tmp_path,
                                                     monkeypatch):
    """`evaluate_map` over a torchvision-mode `DetectionSource` of 3 PNGs
    at batch 2 (the ragged tail padded with the last sample and skipped) on
    the 96 px canvas (torchvision's 800 / 1333 scaled to 64 / 96 so the
    resized images fit it; their content sizes reach the model, the second
    batch's extent, 96 x 64, below the canvas): the
    predictions and targets it hands the metric, image by image, against
    the JAX package's (validity and labels exactly, scores 1e-4 / 1e-5,
    boxes 1e-2 px), and the mAP they give."""
    for mod in (tdet, jdet):
        monkeypatch.setattr(mod, "TV_MIN_SIZE", 64)
        monkeypatch.setattr(mod, "TV_MAX_SIZE", 96)
    paths, targets = _write_kvasir(tmp_path, [(70, 90), (130, 101),
                                              (48, 60)])
    sd, variables = weights
    got_seen = _record_updates(monkeypatch, tmetric.MeanAveragePrecision)
    ref_seen = _record_updates(monkeypatch, jmetric.MeanAveragePrecision)
    got = tdet.evaluate_map(port_model(sd),
                            tdet.DetectionSource(paths, targets, S,
                                                 resize="torchvision"),
                            batch_size=2, device="cpu")
    ref = jdet.evaluate_map(jax_model(), variables["params"],
                            jdet.DetectionSource(paths, targets, S,
                                                 resize="torchvision"),
                            batch_size=2,
                            batch_stats=variables["batch_stats"])
    assert [len(p) for p, _ in got_seen] == [len(p) for p, _ in ref_seen] \
        == [2, 1]
    n_preds = 0
    for (gp, gt), (rp, rt) in zip(got_seen, ref_seen):
        for a, r in zip(gt, rt):
            for k in r:
                np.testing.assert_array_equal(a[k], r[k])
        for a, r in zip(gp, rp):
            assert len(a["scores"]) == len(r["scores"])
            np.testing.assert_array_equal(a["labels"], r["labels"])
            np.testing.assert_allclose(a["scores"], r["scores"], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(a["boxes"], r["boxes"], rtol=1e-4,
                                       atol=1e-2)
            n_preds += len(a["scores"])
    assert n_preds
    assert set(got) == {"map", "map_50", "map_75"}
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [ref[k] for k in sorted(got)], atol=1e-6)


# ------------------------------------------------- weights and devices

def test_param_count_and_converter_round_trip_match_jax():
    """The port's FasterRCNN(resnet50) has the JAX tree's parameters one
    for one, and the converter's two directions are exact inverses on a
    random tree of the JAX shapes, BatchNorm statistics included; the
    inverse returns copies."""
    jm = jax_model()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3), jnp.float32)))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = FasterRCNN(arch="resnet50", image_size=S, device="cpu", **KW)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)
    model.load_state_dict(conv.faster_rcnn_rn50_params_to_torch(
        tree["params"], tree["batch_stats"]))
    back = conv.faster_rcnn_rn50_state_dict_to_params(model.state_dict())
    for got, want in zip(back, (tree["params"], tree["batch_stats"])):
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        ref = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat) == len(ref)
        for path, leaf in ref:
            np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))
    before = back[1]["backbone"]["body"]["bn1"]["mean"].copy()
    with torch.no_grad():
        model.backbone.body.bn1.running_mean.add_(1.0)
    np.testing.assert_array_equal(back[1]["backbone"]["body"]["bn1"]["mean"],
                                  before)


def test_rn50_detector_and_evaluate_map_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FasterRCNN(arch="resnet50", image_size=64)
    model = FasterRCNN(arch="resnet50", image_size=64, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.evaluate_map(model, tdet.SyntheticDetectionSource(2, 64))
    with pytest.raises(ValueError):
        FasterRCNN(arch="resnet18", image_size=64, device="cpu")
