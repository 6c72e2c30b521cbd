"""The port's predictors (`ssl4gie_tpu_torch/tasks/predict.py`) against
the JAX package's (`ssl4gie_tpu/tasks/predict.py`), on the CPU in float32:
`draw_boxes` bitwise, the colormap tables and lookup against matplotlib and
JAX's `_colormap`, and each render against the PNG that JAX's predictor
writes on the same weights (segmentation and depth: the narrow ViT + DPT
through the inverse converters; detection: JAX's drawing and box mapping
fed the port detector's detections, since JAX's ViT detector is full
width). Pixel for pixel; the one exception is a threshold tie: a mask
pixel whose resized logit lies within 1e-5 of 0, or a colormapped value
within 1e-5 of an entry's edge (k / 256), where float32 sums of two
libraries may round to either side."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ssl4gie_tpu.tasks import detection as jdet
from ssl4gie_tpu.tasks import predict as jpred
from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
from ssl4gie_tpu_torch.ops.resize import resize_bilinear
from ssl4gie_tpu_torch.tasks import detection as tdet
from ssl4gie_tpu_torch.tasks import predict as tpred
from ssl4gie_tpu_torch.tasks.colormaps import COLORMAPS
from ssl4gie_tpu_torch.tasks.evaluate import _forward_fn
from test_torch_segmentation import _jax_model, _port_model

torch.set_num_threads(1)

S = 224
TIE = 1e-5
DET_SIZE = 256
DET = dict(depth=3, embed_dim=64, num_heads=2, rpn_pre_nms_top_n_test=100,
           rpn_post_nms_top_n_test=50, detections_per_img=10)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im)


def test_draw_boxes_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(-10, 90, (6, 2)),
                            rng.uniform(-10, 90, (6, 2))], axis=1)
    boxes = np.concatenate([np.minimum(boxes[:, :2], boxes[:, 2:]),
                            np.maximum(boxes[:, :2], boxes[:, 2:])], axis=1)
    boxes[0] = [10.5, 3.5, 20.49, 30.51]                 # rounding edges
    for thickness in (1, 2, 3):
        ref = jpred.draw_boxes(img, boxes, (0, 255, 0), thickness)
        out = tpred.draw_boxes(img, boxes, (0, 255, 0), thickness)
        np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, img)


@pytest.mark.parametrize("name", ["magma", "bone"])
def test_colormap_tables_and_lookup_match_matplotlib(name):
    """The constant tables are matplotlib's, and the lookup of float32 and
    float64 values (0, 1, every entry's edges, NaN, out of range) gives
    JAX's `_colormap` bytes."""
    import matplotlib
    cmap = matplotlib.colormaps[name]
    ref_table = (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(COLORMAPS[name], ref_table)
    edges = np.arange(257) / 256.0
    x = np.concatenate([edges, edges - 1e-7, edges + 1e-7,
                        np.random.default_rng(1).random(1000),
                        [np.nan, -0.5, 1.5]])
    for dt in (np.float32, np.float64):
        xs = x.astype(dt).reshape(-1, 2)
        np.testing.assert_array_equal(tpred._colormap(xs, name),
                                      jpred._colormap(xs, name))


class _SegSource:
    """Random 224 px images with masks at native sizes above and below it."""
    SIZES = ((300, 250), (120, 160))

    def __len__(self):
        return len(self.SIZES)

    def get(self, i):
        rng = np.random.default_rng(10 + i)
        h, w = self.SIZES[i]
        return {"image": rng.integers(0, 256, (S, S, 3), dtype=np.uint8),
                "mask": np.zeros((h, w, 1), np.float32)}


def test_render_segmentation_matches_jax(tmp_path):
    model, params, stats = _jax_model("seg")
    port = _port_model("seg", params, stats)
    src = _SegSource()
    written = jpred.predict_segmentation(None, model, params, stats, src,
                                         str(tmp_path))
    fwd, _ = _forward_fn(port)
    for i, path in enumerate(written):
        s = src.get(i)
        out = tpred.render_segmentation(port, s)
        ref = _png(path)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        logits = resize_bilinear(fwd(s["image"][None]),
                                 *s["mask"].shape[:2])[0, :, :, 0].numpy()
        tie = np.abs(logits) < TIE
        np.testing.assert_array_equal(out[~tie], ref[~tie])
        assert 0 < (out == 255).mean() < 1     # both classes present
    written = tpred.predict_segmentation(None, port, src, str(tmp_path / "t"),
                                         [1])
    np.testing.assert_array_equal(_png(written[0]),
                                  tpred.render_segmentation(port, src.get(1)))


class _DepthSource:
    def __len__(self):
        return 2

    def get(self, i):
        rng = np.random.default_rng(20 + i)
        yy, xx = np.mgrid[:S, :S] / S
        depth = (0.2 + 0.5 * yy + 0.2 * xx * (i + 1)).astype(np.float32)
        depth[:8] = 0                       # no ground truth: error 0
        return {"image": rng.integers(0, 256, (S, S, 3), dtype=np.uint8),
                "depth": depth[..., None]}


def test_render_depth_matches_jax(tmp_path):
    model, params, stats = _jax_model("depth")
    port = _port_model("depth", params, stats)
    src = _DepthSource()
    written = jpred.predict_depth(None, model, params, stats, src,
                                  str(tmp_path))
    fwd, _ = _forward_fn(port)
    for i in range(len(src)):
        s = src.get(i)
        depth, err = tpred.render_depth(port, s)
        out = fwd(s["image"][None])[0, :, :, 0].numpy()
        t = s["depth"][:, :, 0]
        mask = t > 0
        # the aligned map as the port computes it, to find the edge ties
        a = np.stack([out[mask], np.ones(mask.sum(), np.float32)], axis=1)
        sc, sh = np.linalg.lstsq(a.astype(np.float64), t[mask], rcond=None)[0]
        aligned = np.clip(sc * out + sh, 0, 1)
        for got, path, val in ((depth, written[2 * i], aligned),
                               (err, written[2 * i + 1],
                                np.where(mask, np.abs(aligned - t), 0))):
            ref = _png(path)
            assert got.dtype == np.uint8 and got.shape == ref.shape == (S, S,
                                                                      3)
            frac = val * 256
            tie = np.abs(frac - np.round(frac)) < 256 * TIE
            np.testing.assert_array_equal(got[~tie], ref[~tie])
        assert (err[:8] == COLORMAPS["bone"][0]).all()
    paths = tpred.predict_depth(None, port, src, str(tmp_path / "t"), [0])
    assert [os.path.basename(p) for p in paths] == ["depth_0.png",
                                                    "error_0.png"]


def _kvasir(root, sizes):
    """Kvasir-layout frames (PNG, lossless) with one to three boxes each."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    targets, paths = {}, []
    for i, (w, h) in enumerate(sizes):
        rng = np.random.default_rng(30 + i)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(1, 4))
        xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.35, (n, 2)) * (w, h)
        boxes = np.concatenate([xy, np.minimum(xy + wh, (w, h))], axis=1)
        targets[f"f{i}"] = {"bbox": [dict(zip(("xmin", "ymin", "xmax",
                                               "ymax"), map(float, b)))
                                     for b in boxes]}
        paths.append(os.path.join(root, "images", f"f{i}.png"))
        Image.fromarray(img).save(paths[-1])
    return paths, targets


@pytest.fixture(scope="module")
def detector():
    """The narrow ViT detector, its box head biased to the foreground so
    that detections pass 0.5."""
    model = FasterRCNN(image_size=DET_SIZE, device="cpu",
                       generator=torch.Generator().manual_seed(0), **DET)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias.copy_(
            torch.tensor([-3.0, 3.0]))
    return model


@pytest.mark.parametrize("files", [True, False])
def test_render_detection_matches_jax(detector, files, tmp_path,
                                      monkeypatch):
    """On originals larger than the canvas (halved, then centered: the
    boxes mapped back) and on synthetic canvases: the port's render equals
    the PNG of JAX's `predict_detection`, whose eval step is replaced by
    the port detector's (the same detections on both sides)."""
    if files:
        paths, targets = _kvasir(str(tmp_path / "kv"), ((300, 280),
                                                        (200, 240)))
        jsrc = jdet.DetectionSource(paths, targets, DET_SIZE)
        tsrc = tdet.DetectionSource(paths, targets, DET_SIZE)
    else:
        jsrc = jdet.SyntheticDetectionSource(2, DET_SIZE, seed=3)
        tsrc = tdet.SyntheticDetectionSource(2, DET_SIZE, seed=3)
    step = tdet.make_detection_eval_step(detector)

    def port_eval_step(model, batch_stats):
        def run(params, img, cs):
            det = step(torch.from_numpy(np.array(img)),
                       None if cs is None else torch.from_numpy(
                           np.asarray(cs)))
            return {k: jnp.asarray(v.numpy()) for k, v in det.items()}
        return run

    monkeypatch.setattr(jdet, "make_detection_eval_step", port_eval_step)
    written = jpred.predict_detection(None, None, None, None, jsrc,
                                      str(tmp_path / "j"))
    mine = tpred.predict_detection(None, detector, tsrc, str(tmp_path / "t"))
    drawn = 0
    for i, (ref_path, path) in enumerate(zip(written, mine)):
        ref = _png(ref_path)
        out = tpred.render_detection(detector, tsrc.get(i))
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(_png(path), ref)
        s = tsrc.get(i)
        base = s["original"] if files else s["image"]
        assert out.shape == base.shape
        drawn += int((out == (0, 255, 0)).all(-1).sum())
    assert drawn > 0        # predictions were drawn
