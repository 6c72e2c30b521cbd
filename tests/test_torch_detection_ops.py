"""The port's detection ops and heads (`ssl4gie_tpu_torch/ops`,
`models/rpn.py`, `models/roi_heads.py`) against the JAX package's, on the
same inputs and, for the samplers, the same noise (the JAX draws are
replayed from their keys and handed to the port). Index-valued results
(NMS, anchors, matching, sampling, proposal selection, level assignment)
must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.models import roi_heads as jroi
from ssl4gie_tpu.models import rpn as jrpn
from ssl4gie_tpu.ops import boxes as jboxes
from ssl4gie_tpu.ops import nms as jnms
from ssl4gie_tpu.ops import roi_align as jra
from ssl4gie_tpu_torch.models import roi_heads as troi
from ssl4gie_tpu_torch.models import rpn as trpn
from ssl4gie_tpu_torch.ops import boxes as tboxes
from ssl4gie_tpu_torch.ops import nms as tnms
from ssl4gie_tpu_torch.ops import roi_align as tra

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray


def _boxes(rng, n, lo=0.0, hi=200.0, wmin=4.0, wmax=80.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wmin, wmax, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _np(x):
    return np.asarray(x)


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 7)
    b[3] = b[2]                                  # a duplicate: IoU exactly 1
    np.testing.assert_array_equal(tboxes.box_iou(T(a), T(b)).numpy(),
                                  _np(jboxes.box_iou(J(a), J(b))))
    deltas = rng.normal(0, 1, (40, 4)).astype(np.float32)
    deltas[0, 2:] = 9.0                          # past the log-space clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            tboxes.encode_boxes(T(a[::-1].copy()), T(a), w).numpy(),
            _np(jboxes.encode_boxes(J(a[::-1]), J(a), w)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tboxes.decode_boxes(T(deltas), T(a), w).numpy(),
            _np(jboxes.decode_boxes(J(deltas), J(a), w)), rtol=1e-6, atol=1e-4)
    big = a * 1.5 - 20.0
    np.testing.assert_array_equal(tboxes.clip_boxes(T(big), 150, 120).numpy(),
                                  _np(jboxes.clip_boxes(J(big), 150, 120)))
    tiny = a.copy()
    tiny[::3, 2] = tiny[::3, 0] + 5e-4
    np.testing.assert_array_equal(tboxes.small_box_mask(T(tiny)).numpy(),
                                  _np(jboxes.small_box_mask(J(tiny))))
    p, t = deltas, rng.normal(0, 0.2, (40, 4)).astype(np.float32)
    np.testing.assert_allclose(tboxes.smooth_l1(T(p), T(t)).numpy(),
                               _np(jboxes.smooth_l1(J(p), J(t))), rtol=1e-6)


@pytest.mark.parametrize("k", [30, 120])
def test_nms_matches_jax_exactly(k):
    """Indices and validity of the greedy slot loop, per image in a batch of
    two, with invalid inputs and (at k = 120 > survivors) exhausted slots;
    then the level-offset batched form."""
    rng = np.random.default_rng(1)
    B, n = 2, 100
    boxes = np.stack([_boxes(rng, n) for _ in range(B)])
    scores = rng.uniform(0, 1, (B, n)).astype(np.float32)
    scores[1, :5] = scores[1, 5]                 # tied scores: first index wins
    valid = rng.uniform(0, 1, (B, n)) > 0.2
    idx, ok = tnms.nms_topk(T(boxes), T(scores), 0.5, k, T(valid))
    levels = rng.integers(0, 3, (B, n)).astype(np.int32)
    bidx, bok = tnms.batched_nms_topk(T(boxes), T(scores), T(levels), 0.5, k,
                                      T(valid))
    for i in range(B):
        ridx, rok = jnms.nms_topk(J(boxes[i]), J(scores[i]), 0.5, k,
                                  J(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), _np(ridx))
        np.testing.assert_array_equal(ok[i].numpy(), _np(rok))
        ridx, rok = jnms.batched_nms_topk(J(boxes[i]), J(scores[i]),
                                          J(levels[i]), 0.5, k, J(valid[i]))
        np.testing.assert_array_equal(bidx[i].numpy(), _np(ridx))
        np.testing.assert_array_equal(bok[i].numpy(), _np(rok))
    if k == 120:
        assert not ok.all() and not bok.all()


def _pyramid(rng, B=2, C=8, size=128):
    return [rng.normal(0, 1, (B, size // s, size // s, C)).astype(np.float32)
            for s in (4, 8, 16, 32)]


def test_fpn_level_assignment_matches_jax_exactly():
    rng = np.random.default_rng(2)
    rois = np.concatenate([_boxes(rng, 64, wmin=2, wmax=600),
                           np.asarray([[5, 5, 5, 9], [0, 0, 224, 224],
                                       [0, 0, 112, 112]], np.float32)])
    np.testing.assert_array_equal(tra.fpn_level_assignment(T(rois)).numpy(),
                                  _np(jra.fpn_level_assignment(J(rois))))


@pytest.mark.parametrize("extent", [False, True])
def test_multiscale_roi_align_matches_jax(extent):
    """Values and the gradient with respect to the feature maps, 1e-5; rois
    over all levels, partly outside the canvas."""
    rng = np.random.default_rng(3)
    feats = _pyramid(rng)
    rois = np.stack([_boxes(rng, 24, lo=-20, hi=120, wmin=3, wmax=130)
                     for _ in range(2)])
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    ext = (np.asarray([[24, 28], [12, 14], [6, 7], [3, 3]], np.float32)
           if extent else None)
    cot = rng.normal(0, 1, (2, 24, 7, 7, 8)).astype(np.float32)

    tf = [T(f).requires_grad_(True) for f in feats]
    out = tra.multiscale_roi_align(tf, T(rois), scales,
                                   extent_hw=None if ext is None else T(ext))
    (out * T(cot)).sum().backward()
    for i in range(2):
        ref, vjp = jax.vjp(
            lambda *fs: jra.multiscale_roi_align(list(fs), J(rois[i]), scales,
                                                 extent_hw=ext),
            *[J(f[i]) for f in feats])
        np.testing.assert_allclose(out[i].detach().numpy(), _np(ref),
                                   rtol=1e-5, atol=1e-5)
        for f, g in zip(tf, vjp(J(cot[i]))):
            np.testing.assert_allclose(f.grad[i].numpy(), _np(g), rtol=1e-5,
                                       atol=1e-5)


def test_anchors_match_jax_exactly():
    shapes, strides = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)], \
        (4, 8, 16, 32, 64)
    np.testing.assert_array_equal(trpn.generate_anchors(shapes, strides),
                                  jrpn.generate_anchors(shapes, strides))
    np.testing.assert_array_equal(trpn.anchor_grid_info(shapes, strides),
                                  jrpn.anchor_grid_info(shapes, strides))


def _gt(rng, B=2, G=16):
    gt = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    labels = np.zeros((B, G), np.int32)
    for b in range(B):
        n = 3 if b == 0 else 1
        gt[b, :n] = _boxes(rng, n, hi=90, wmin=20, wmax=60)
        valid[b, :n] = True
        labels[b, :n] = 1
    return gt, labels, valid


def test_match_and_sample_anchors_match_jax_exactly():
    """match_anchors, sample_balanced at the JAX sampler's noise, and the
    per-image RPN losses; one image without any GT box."""
    rng = np.random.default_rng(4)
    anchors = jrpn.generate_anchors([(32, 32), (16, 16), (8, 8)], (4, 8, 16))
    gt, _, valid = _gt(rng, B=3)
    valid[2] = False
    m, lab = trpn.match_anchors(T(anchors), T(gt), T(valid))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    rand = np.stack([_np(jax.random.uniform(k, (anchors.shape[0],)))
                     for k in keys])
    pos, neg = trpn.sample_balanced(T(rand), lab, 256, 0.5)
    obj = rng.normal(0, 2, (3, anchors.shape[0])).astype(np.float32)
    dl = rng.normal(0, 0.5, (3, anchors.shape[0], 4)).astype(np.float32)
    ol, bl = trpn.rpn_loss(T(rand), T(anchors), T(obj), T(dl), T(gt),
                           T(valid))
    for b in range(3):
        rm, rl = jrpn.match_anchors(J(anchors), J(gt[b]), J(valid[b]))
        np.testing.assert_array_equal(m[b].numpy(), _np(rm))
        np.testing.assert_array_equal(lab[b].numpy(), _np(rl))
        rp, rn = jrpn.sample_balanced(keys[b], rl, 256, 0.5)
        np.testing.assert_array_equal(pos[b].numpy(), _np(rp))
        np.testing.assert_array_equal(neg[b].numpy(), _np(rn))
        rol, rbl = jrpn.rpn_loss(keys[b], J(anchors), J(obj[b]), J(dl[b]),
                                 J(gt[b]), J(valid[b]))
        np.testing.assert_allclose(ol[b].item(), float(rol), rtol=1e-5)
        np.testing.assert_allclose(bl[b].item(), float(rbl), rtol=1e-5)
    assert pos[0].sum() > 0 and pos[2].sum() == 0


def _jax_select(obj, dl, anchors, slices, **kw):
    return jrpn.select_proposals(J(obj), J(dl), J(anchors), None, slices,
                                 **kw)


def test_select_proposals_matches_jax_exactly():
    """The kept candidates' indices and validity exactly equal; the boxes to
    rounding. Ties in the objectness are broken by index, as top_k does."""
    rng = np.random.default_rng(6)
    shapes = [(16, 16), (8, 8), (4, 4)]
    anchors = trpn.generate_anchors(shapes, (4, 8, 16))
    sizes = [h * w * 3 for h, w in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    slices = [(offs[i], offs[i + 1]) for i in range(3)]
    B, N = 2, anchors.shape[0]
    obj = rng.normal(0, 1, (B, N)).astype(np.float32)
    obj[:, 10:20] = obj[:, 5:6]                  # ties
    dl = rng.normal(0, 0.3, (B, N, 4)).astype(np.float32)
    kw = dict(image_size=64, pre_nms_top_n=120, post_nms_top_n=60,
              nms_thresh=0.7)
    boxes, ok, idx = trpn.select_proposals(T(obj), T(dl), T(anchors), slices,
                                           return_index=True, **kw)
    for b in range(B):
        rb, rok = _jax_select(obj[b], dl[b], anchors, slices, **kw)
        np.testing.assert_array_equal(ok[b].numpy(), _np(rok))
        np.testing.assert_allclose(boxes[b].numpy(), _np(rb), rtol=1e-6,
                                   atol=1e-4)
        # JAX returns boxes: recover its candidate indices by matching them
        # against its own candidates, then compare the indices exactly where
        # the match is unique (several candidates can clip to one box)
        cand = _candidates(obj[b], dl[b], anchors, slices, 120)
        d = np.abs(cand[None, :, :] - _np(rb)[:, None, :]).sum(-1)
        ref_idx = d.argmin(1)
        v = _np(rok)
        unique = np.sort(d, axis=1)[:, 1] > 1e-3
        assert unique[v].mean() > 0.9
        np.testing.assert_array_equal(idx[b].numpy()[v & unique],
                                      ref_idx[v & unique])
        np.testing.assert_allclose(cand[idx[b].numpy()][v], _np(rb)[v],
                                   rtol=1e-6, atol=1e-4)


def _candidates(obj, dl, anchors, slices, pre_n):
    """The JAX package's per-level top-k candidates (decoded, clipped)."""
    out = []
    for s, e in slices:
        k = min(pre_n, e - s)
        _, i = jax.lax.top_k(J(obj[s:e]), k)
        i = _np(i)
        out.append(jboxes.clip_boxes(
            jboxes.decode_boxes(J(dl[s:e][i]), J(anchors[s:e][i])), 64, 64))
    return np.concatenate([_np(o) for o in out])


def test_roi_sampling_and_losses_match_jax():
    """assign_proposals at the JAX sampler's and tie-break's noise (exactly
    equal), then the RoI losses (1e-6) and the postprocess (indices and
    validity exactly, boxes and scores to rounding)."""
    rng = np.random.default_rng(7)
    B, P, S = 2, 60, 32
    props = np.stack([_boxes(rng, P, hi=90, wmin=10, wmax=60)
                      for _ in range(B)])
    pvalid = rng.uniform(0, 1, (B, P)) > 0.1
    gt, labels, valid = _gt(rng, B)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    samp, tie = [], []
    for k in keys:
        ks, kt = jax.random.split(k)
        samp.append(_np(jax.random.uniform(ks, (P + 16,))))
        tie.append(_np(jax.random.uniform(kt, (P + 16,))))
    got = troi.assign_proposals(T(np.stack(samp)), T(np.stack(tie)), T(props),
                                T(pvalid), T(gt), T(labels), T(valid), S)
    for b in range(B):
        ref = jroi.assign_proposals(keys[b], J(props[b]), J(pvalid[b]),
                                    J(gt[b]), J(labels[b]), J(valid[b]), S)
        for i, (g, r) in enumerate(zip(got, ref)):
            if i == 2:       # regression targets: a log, to rounding
                np.testing.assert_allclose(g[b].numpy(), _np(r), rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g[b].numpy(), _np(r))

    K = 3
    scores = rng.normal(0, 1, (B * S, K)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (B * S, K, 4)).astype(np.float32)
    cls = got[1].reshape(-1).numpy() % K
    regt, pos, sv = (got[i].reshape((B * S,) + got[i].shape[2:]).numpy()
                     for i in (2, 3, 4))
    tl = troi.roi_head_loss(T(scores), T(deltas), T(cls), T(regt), T(pos),
                            T(sv))
    rl = jroi.roi_head_loss(J(scores), J(deltas), J(cls), J(regt), J(pos),
                            J(sv))
    for a, r in zip(tl, rl):
        np.testing.assert_allclose(a.item(), float(r), rtol=1e-6)

    sc = scores.reshape(B, S, K)
    dl = deltas.reshape(B, S, K, 4)
    pb = props[:, :S]
    pv = pvalid[:, :S]
    det = troi.postprocess_detections(T(sc), T(dl), T(pb), T(pv), 100,
                                      score_thresh=0.2, detections_per_img=12)
    for b in range(B):
        ref = jroi.postprocess_detections(J(sc[b]), J(dl[b]), J(pb[b]),
                                          J(pv[b]), 100,
                                          score_thresh=0.2,
                                          detections_per_img=12)
        np.testing.assert_array_equal(det["valid"][b].numpy(),
                                      _np(ref["valid"]))
        v = _np(ref["valid"])
        np.testing.assert_array_equal(det["labels"][b].numpy()[v],
                                      _np(ref["labels"])[v])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(det[key][b].numpy()[v],
                                       _np(ref[key])[v], rtol=1e-5, atol=1e-4)


def test_resize_and_pos_embed_interpolation_match_jax():
    from ssl4gie_tpu.models.layers import interpolate_pos_embed as jinterp
    from ssl4gie_tpu.ops.resize import resize_bilinear_ac as jresize
    from ssl4gie_tpu_torch.models.layers import interpolate_pos_embed
    from ssl4gie_tpu_torch.ops.resize import resize_bilinear_ac
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 7, 5, 3)).astype(np.float32)
    for oh, ow in ((14, 9), (7, 11), (3, 2)):
        np.testing.assert_allclose(resize_bilinear_ac(T(x), oh, ow).numpy(),
                                   _np(jresize(J(x), oh, ow)), rtol=1e-6,
                                   atol=1e-6)
    pe = rng.normal(0, 0.02, (1, 197, 32)).astype(np.float32)
    for dst in (14, 32, 64):
        np.testing.assert_allclose(
            interpolate_pos_embed(T(pe), 14, dst).numpy(),
            _np(jinterp(jnp.asarray(pe), 14, dst, has_cls=True,
                        method="bilinear")), rtol=1e-6, atol=1e-6)
