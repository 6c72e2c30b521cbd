"""Detection task wiring (port of `ssl4gie_tpu/tasks/detection.py`): the
Kvasir data source, box-aware on-device augmentation, the train step (the
sum of the loss dict, with `accum_steps` microbatch averaging), the eval
step and the COCO mAP evaluation, the synthetic data source, and
`DetectionTrainer`, the epoch driver around them.

Static-shape data contract: every image is placed on a fixed square canvas;
GT boxes are padded to MAX_GT with a validity mask.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ssl4gie_tpu_torch.core.logger import Throughput
from ssl4gie_tpu_torch.core.spans import span
from ssl4gie_tpu_torch.core.train_state import apply_gradients
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, Trainer
from ssl4gie_tpu_torch.data.augment import (HUE, JITTER, SIGMA_RANGE,
                                            color_jitter, gaussian_blur)
from ssl4gie_tpu_torch.data.loader import Loader, Source, prefetch_to_device
from ssl4gie_tpu_torch.parallel import distributed as dist_lib
from ssl4gie_tpu_torch.metrics.detection import MeanAveragePrecision
from ssl4gie_tpu_torch.models.faster_rcnn import MAX_GT
from ssl4gie_tpu_torch.models.layers import default_device


def parse_kvasir_targets(input_path: str, targets: dict):
    """`get_Kvasir_target_vals` (`train_detection.py:154-167`): the boxes
    (n, 4) xyxy float32 and labels (n,) int32 (all 1) of an image."""
    objects = targets[os.path.splitext(os.path.basename(input_path))[0]]["bbox"]
    boxes = np.zeros((len(objects), 4), np.float32)
    for i, obj in enumerate(objects):
        boxes[i] = [obj["xmin"], obj["ymin"], obj["xmax"], obj["ymax"]]
    labels = np.ones((len(objects),), np.int32)
    return boxes, labels


TV_MIN_SIZE = 800      # torchvision GeneralizedRCNNTransform defaults
TV_MAX_SIZE = 1333     # (`fasterrcnn_resnet50_fpn`, `train_detection.py:197`)
TV_CANVAS = 1344       # 1333 rounded up to the FPN's size_divisible=32


def _tv_bilinear_resize(image: np.ndarray, W2: int, H2: int) -> np.ndarray:
    """torchvision `GeneralizedRCNNTransform`'s resize: non-antialiased
    bilinear (`F.interpolate(mode="bilinear", align_corners=False)`) of the
    float image, rounded back to uint8. (H, W, 3) uint8 -> (H2, W2, 3)."""
    t = torch.from_numpy(np.asarray(image, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(H2, W2), mode="bilinear",
                        align_corners=False)
    return out[0].permute(1, 2, 0).round().clamp(0, 255).byte().numpy()


def place_detection(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    canvas: int, resize: str = "fixed",
                    keep_original: bool = False) -> dict:
    """One decoded image (H, W, 3) uint8 with its boxes (n, 4) xyxy and
    labels (n,) -> the sample on a `canvas` square (`DetectionSource`'s
    modes). Keys: image, gt_boxes, gt_labels, gt_valid; content_size (w, h)
    in "torchvision" mode; pad (p1, p2), scale (sx, sy) and the original
    image with `keep_original`."""
    boxes = np.array(boxes, np.float32)
    H, W = image.shape[:2]
    original = image if keep_original else None
    if resize == "torchvision":
        s = min(TV_MIN_SIZE / min(H, W), TV_MAX_SIZE / max(H, W))
        # floor, as torchvision's F.interpolate(scale_factor=s,
        # recompute_scale_factor=True) sizes its output
        W2, H2 = int(W * s), int(H * s)
        image = _tv_bilinear_resize(image, W2, H2)
        boxes[:, [0, 2]] *= W2 / W      # torchvision resize_boxes: per-axis
        boxes[:, [1, 3]] *= H2 / H      # ratios of the actual new/old sizes
        scale = np.asarray([W2 / W, H2 / H], np.float32)
        W, H = W2, H2
        p1 = p2 = 0                     # top-left placement
    else:
        # halve if larger than the canvas (bicubic, `Data/dataset.py:84-99`)
        scale = np.asarray([1.0, 1.0], np.float32)
        if H > canvas or W > canvas:
            from PIL import Image
            if H % 2:
                H += 1
            if W % 2:
                W += 1
            image = np.asarray(Image.fromarray(image).resize(
                (W // 2, H // 2), Image.BICUBIC), np.uint8)
            H, W = image.shape[:2]
            boxes = boxes / 2.0
            scale = np.asarray([0.5, 0.5], np.float32)
        p1 = int(np.floor((canvas - W) / 2))
        p2 = int(np.floor((canvas - H) / 2))
    out_img = np.zeros((canvas, canvas, 3), np.uint8)
    out_img[p2:p2 + H, p1:p1 + W] = image
    boxes[:, [0, 2]] += p1
    boxes[:, [1, 3]] += p2

    n = min(len(boxes), MAX_GT)
    gt_boxes = np.zeros((MAX_GT, 4), np.float32)
    gt_labels = np.zeros((MAX_GT,), np.int32)
    gt_valid = np.zeros((MAX_GT,), bool)
    gt_boxes[:n] = boxes[:n]
    gt_labels[:n] = labels[:n]
    gt_valid[:n] = True
    out = {"image": out_img, "gt_boxes": gt_boxes, "gt_labels": gt_labels,
           "gt_valid": gt_valid}
    if resize == "torchvision":
        # the pre-pad extent (W2, H2): torchvision clips detections to it,
        # and the model emulates its batch-max padding from it
        # (`FasterRCNN(content_sizes=)`). The fixed mode matches the
        # reference's fixed_size canvas, where torchvision clips at the
        # canvas: no key.
        out["content_size"] = np.asarray([W, H], np.int32)
    if keep_original:
        out["pad"] = np.asarray([p1, p2], np.int32)
        out["scale"] = scale                     # per-axis (sx, sy)
        out["original"] = original
    return out


class DetectionSource(Source):
    """Kvasir detection images placed on one static canvas.

    resize modes:
    - "fixed" (ViT path): a 2x bicubic downscale when larger than the
      canvas, then centered on the square canvas: the reference's ViTDet
      prep (`Object_detection/Data/dataset.py:82-106` + fixed_size 1024).
    - "torchvision" (RN50 path): torchvision GeneralizedRCNNTransform
      semantics: bilinear resize by min(800 / min side, 1333 / max side),
      boxes scaled by the per-axis ratios of the actual sizes, the image
      placed top-left on the canvas (1344: torchvision pads a batch to its
      largest image rounded up to /32, which `content_size` lets the model
      emulate).

    `decode` reads an image (PIL) and its boxes; `place_detection` puts
    them on the canvas."""

    def __init__(self, paths: List[str], targets: dict, canvas: int = 1024,
                 keep_original: bool = False, resize: str = "fixed"):
        if resize not in ("fixed", "torchvision"):
            raise ValueError(f"resize {resize!r} not in ('fixed', "
                             "'torchvision')")
        self.paths, self.targets, self.canvas = list(paths), targets, canvas
        self.keep_original = keep_original
        self.resize = resize

    def __len__(self):
        return len(self.paths)

    def decode(self, i):
        """(image (H, W, 3) uint8 RGB, boxes (n, 4), labels (n,))."""
        from PIL import Image
        path = self.paths[i]
        boxes, labels = parse_kvasir_targets(path, self.targets)
        with Image.open(path) as im:
            image = np.asarray(im.convert("RGB"), np.uint8)
        return image, boxes, labels

    def get(self, i):
        return place_detection(*self.decode(i), self.canvas, self.resize,
                               self.keep_original)


def clip_to_content(boxes: np.ndarray, content_size) -> np.ndarray:
    """Clip boxes (N, 4) xyxy to an image's pre-pad size (W, H), as
    torchvision's `RoIHeads.postprocess_detections` clips to image_shapes."""
    cw, ch = float(content_size[0]), float(content_size[1])
    boxes = np.asarray(boxes, np.float32)
    return np.stack([np.clip(boxes[:, 0], 0, cw), np.clip(boxes[:, 1], 0, ch),
                     np.clip(boxes[:, 2], 0, cw), np.clip(boxes[:, 3], 0, ch)],
                    axis=1)


def boxes_to_original(boxes: np.ndarray, pad: np.ndarray,
                      scale: np.ndarray) -> np.ndarray:
    """Map canvas boxes (N, 4) xyxy back to the original image's
    coordinates, inverting `place_detection`: the reference's
    `(box - pad) / scale` (`predict_detection.py:29-44`). pad (p1, p2);
    scale per axis (sx, sy)."""
    out = np.asarray(boxes, np.float32).copy()
    p1, p2 = float(pad[0]), float(pad[1])
    sx, sy = float(scale[0]), float(scale[1])
    out[:, [0, 2]] = (out[:, [0, 2]] - p1) / sx
    out[:, [1, 3]] = (out[:, [1, 3]] - p2) / sy
    return out


class SyntheticDetectionSource(Source):
    """Random uint8 canvases with 1-3 painted boxes each (the JAX package's
    `SyntheticDetectionSource`, same numpy draws)."""

    def __init__(self, n: int, canvas: int = 256, seed: int = 0):
        self.n, self.canvas, self.seed = n, canvas, seed

    def __len__(self):
        return self.n

    def get(self, i):
        rng = np.random.default_rng(self.seed * 7919 + i)
        img = rng.integers(0, 256, (self.canvas, self.canvas, 3), dtype=np.uint8)
        n_obj = int(rng.integers(1, 4))
        gt_boxes = np.zeros((MAX_GT, 4), np.float32)
        gt_labels = np.zeros((MAX_GT,), np.int32)
        gt_valid = np.zeros((MAX_GT,), bool)
        for j in range(n_obj):
            x0, y0 = rng.uniform(0, self.canvas * 0.6, 2)
            w, h = rng.uniform(self.canvas * 0.1, self.canvas * 0.35, 2)
            gt_boxes[j] = [x0, y0, min(x0 + w, self.canvas),
                           min(y0 + h, self.canvas)]
            gt_labels[j] = 1
            gt_valid[j] = True
            # paint the object so there is signal
            img[int(y0):int(gt_boxes[j, 3]), int(x0):int(gt_boxes[j, 2])] = \
                rng.integers(180, 256, 3)
        return {"image": img, "gt_boxes": gt_boxes, "gt_labels": gt_labels,
                "gt_valid": gt_valid}

    def batch(self, indices) -> dict:
        """The samples `indices` stacked into numpy arrays."""
        samples = [self.get(i) for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ------------------------------------------------------------ augmentation

def sample_detection_params(B: int, generator: torch.Generator) -> dict:
    """Draw every random factor of `detection_augment` on the generator's
    device, with the JAX package's ranges: jitter factors U[1-x, 1+x] (hue
    U[-h, h]) and one op order per batch, blur sigma U[0.001, 2], and the
    rot90, h-flip and v-flip flags with probability 0.5 each."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B,), generator=generator,
                                           device=dev)

    params = {name: uniform(1 - x, 1 + x) for name, x in JITTER.items()}
    params.update(
        hue=uniform(-HUE, HUE),
        order=torch.randperm(4, generator=generator, device=dev).tolist(),
        sigma=uniform(*SIGMA_RANGE))
    for flag in ("rot", "hflip", "vflip"):
        params[flag] = torch.rand((B,), generator=generator, device=dev) > 0.5
    return params


def detection_augment(img_u8: torch.Tensor, gt_boxes: torch.Tensor,
                      params: dict):
    """(B, S, S, 3) uint8 and (B, G, 4) xyxy boxes -> float32 images in
    [0, 1] and the moved boxes: color jitter and blur, then rot90 (counter-
    clockwise, `jnp.rot90(k=1, axes=(1, 2))`), h-flip and v-flip with the
    reference's box bookkeeping (`Data/dataset.py:50-80`). No normalize:
    the model normalizes. Float32 on every device, as the JAX package."""
    p = {k: v.to(img_u8.device) if torch.is_tensor(v) else v
         for k, v in params.items()}
    B, S = img_u8.shape[0], img_u8.shape[1]
    img = img_u8.to(torch.float32) / 255.0
    img = color_jitter(img, p["brightness"], p["contrast"], p["saturation"],
                       p["hue"], p["order"])
    img = gaussian_blur(img, p["sigma"])

    Sf = float(S)
    x0, y0, x1, y1 = gt_boxes.unbind(-1)
    r = p["rot"][:, None]
    img = torch.where(p["rot"].reshape(B, 1, 1, 1),
                      torch.rot90(img, 1, dims=(1, 2)), img)
    x0, y0, x1, y1 = (torch.where(r, y0, x0), torch.where(r, Sf - x1, y0),
                      torch.where(r, y1, x1), torch.where(r, Sf - x0, y1))
    h = p["hflip"][:, None]
    img = torch.where(p["hflip"].reshape(B, 1, 1, 1), img.flip(2), img)
    x0, x1 = torch.where(h, Sf - x1, x0), torch.where(h, Sf - x0, x1)
    v = p["vflip"][:, None]
    img = torch.where(p["vflip"].reshape(B, 1, 1, 1), img.flip(1), img)
    y0, y1 = torch.where(v, Sf - y1, y0), torch.where(v, Sf - y0, y1)
    return img, torch.stack([x0, y0, x1, y1], dim=-1)


# ------------------------------------------------------------ train step

def make_detection_train_step(accum_steps: int = 1):
    """Returns train_step(model, optimizer, batch, generator=None,
    noise=None) -> {"loss": total, and each loss of the dict}, averaged over
    the microbatches. Spans (`core/spans.py`): `ssl4gie.forward` (the model
    and its loss dict, `nms_topk` inside) and `ssl4gie.backward` once a
    microbatch, then `ssl4gie.optimizer` (the accumulated gradients'
    division and the update). `batch` holds "image", "gt_boxes", "gt_labels",
    "gt_valid" (batch on dim 0, divisible by `accum_steps`). The samplers'
    noise comes from `noise` (one dict per microbatch, as
    `FasterRCNN.draw_noise` gives) or is drawn from `generator`."""

    def train_step(model, optimizer, batch: dict,
                   generator: torch.Generator | None = None,
                   noise: list | None = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images = batch["image"]
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        mb = images.shape[0] // accum_steps
        sums = {}
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            with dist_lib.gradient_sync(model, i == accum_steps - 1):
                with span("ssl4gie.forward"):
                    losses = model(images[sl], batch["gt_boxes"][sl],
                                   batch["gt_labels"][sl],
                                   batch["gt_valid"][sl], train=True,
                                   generator=generator,
                                   noise=None if noise is None else noise[i])
                    total = sum(losses.values())
                with span("ssl4gie.backward"):
                    total.backward()       # sums the microbatch gradients
            for k, v in {"loss": total, **losses}.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        with span("ssl4gie.optimizer"):
            if accum_steps > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            apply_gradients(optimizer)
        return {k: dist_lib.global_mean(v / accum_steps)
                for k, v in sums.items()}

    return train_step


def make_detection_full_step(accum_steps: int = 1):
    """Returns full_step(model, optimizer, batch, generator,
    model_generator=None): sample the augmentation from `generator`,
    augment the uint8 batch on its device, then take one train step, whose
    sampler noise comes from `model_generator` (by default `generator`).
    The whole is the span `ssl4gie.step`, the draws and the augmentation
    `ssl4gie.augment`."""
    step = make_detection_train_step(accum_steps)

    def full_step(model, optimizer, batch: dict, generator: torch.Generator,
                  model_generator: torch.Generator | None = None):
        with span("ssl4gie.step"):
            with span("ssl4gie.augment"):
                params = dist_lib.draw_global(sample_detection_params,
                                              batch["image"].shape[0],
                                              generator,
                                              accum_steps=accum_steps)
                img, boxes = detection_augment(batch["image"],
                                               batch["gt_boxes"], params)
            return step(model, optimizer,
                        dict(batch, image=img, gt_boxes=boxes),
                        generator if model_generator is None
                        else model_generator)

    return full_step


# ------------------------------------------------------------ evaluation

def make_detection_eval_step(model):
    """Returns eval_step(images, content_sizes=None) -> the detections of
    `model`'s eval forward, without autograd. images (B, S, S, 3) float in
    [0, 1]; content_sizes (B, 2) (w, h) or None."""

    def eval_step(images, content_sizes=None):
        model.eval()
        with torch.no_grad():
            return model(images, content_sizes=content_sizes)

    return eval_step


def evaluate_map(model, source, batch_size: int = 2,
                 device=None) -> Dict[str, float]:
    """Detect over every sample of `source` and return its COCO mAP
    (`map`, `map_50`, `map_75`). The batches are made on `device`: the
    card when none is given (no card raises), which must hold `model`.
    Under data parallelism the ranks take the batches in turn, and every
    rank's detections are gathered, in order, into one metric."""
    device = default_device(device)
    eval_step = make_detection_eval_step(dist_lib.unwrap(model))
    metric = MeanAveragePrecision()
    n = len(source)
    rank, ranks = dist_lib.data_shard()
    done = []
    for start in list(range(0, n, batch_size))[rank::ranks]:
        # every image enters the metric; the ragged tail is padded by
        # repeating the last sample, so each batch has one shape, and the
        # padded rows are skipped below
        real = min(batch_size, n - start)
        samples = [source.get(start + min(i, real - 1))
                   for i in range(batch_size)]
        imgs = torch.from_numpy(np.stack([s["image"] for s in samples])).to(
            device).to(torch.float32) / 255.0
        # torchvision-mode samples carry their pre-pad extents: the model
        # emulates torchvision's batch-max padding from them (anchor mask,
        # clips before each NMS), and clip_to_content below is then a no-op
        # kept as a guard
        cs = None
        if all("content_size" in s for s in samples):
            cs = torch.from_numpy(np.stack([s["content_size"]
                                            for s in samples])).to(device)
        det = {k: v.cpu().numpy() for k, v in eval_step(imgs, cs).items()}
        preds, targets = [], []
        for bi, s in enumerate(samples[:real]):
            ok = det["valid"][bi]
            pb = det["boxes"][bi][ok]
            if "content_size" in s:
                pb = clip_to_content(pb, s["content_size"])
            preds.append({"boxes": pb, "scores": det["scores"][bi][ok],
                          "labels": det["labels"][bi][ok]})
            gv = s["gt_valid"]
            targets.append({"boxes": s["gt_boxes"][gv],
                            "labels": s["gt_labels"][gv]})
        done.append((start, preds, targets))
    if ranks > 1:
        done = sorted((b for r in dist_lib.gather_objects(done) for b in r),
                      key=lambda b: b[0])
    for _, preds, targets in done:
        metric.update(preds, targets)
    return metric.compute()


# ------------------------------------------------------------ trainer

# The engine's view of detection: the model returns its loss dict, so no
# loss_fn; selection on val mAP; `has_dropout` because the samplers draw
# noise inside the model (per anchor), which on the card comes from a card
# generator seeded as the host one (`Trainer.generators`).
DETECTION_TASK = TaskDefinition(name="detection", aug_mode="detection",
                                target_key="gt_boxes", loss_fn=None,
                                select_mode="max", has_dropout=True)


class DetectionTrainer(Trainer):
    """The detection engine (JAX `tasks/detection.py:DetectionTrainer`):
    loss-dict training with `accum_steps` microbatches, COCO mAP on val and
    test each epoch (`train_detection.py:330`), the plateau on val mAP, the
    best-val checkpoint, resume and preemption. The epoch bookkeeping
    (`fit`, `maybe_resume`, `_check_preempted`, `_ckpt_tree`) is
    `Trainer`'s, as the JAX class mirrors it; the model's state dict holds
    the RN50 body's frozen statistics as buffers. Randomness per epoch as
    `Trainer`'s: the augmentation from a host generator seeded from
    (seed, epoch), so `sample_detection_params`' `randperm(...).tolist()`
    never waits for the card, and the samplers' noise from the card
    generator seeded the same (the host one on the CPU)."""

    BEST_KEYS = ("new_best_val_map", "test_map_at_best")

    def __init__(self, *, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, device, train_source,
                 val_source, test_source, logger, ckpt, epochs: int,
                 batch_size: int, accum_steps: int = 1, seed: int = 42,
                 num_threads: int = 8, plateau=None, log_every: int = 10,
                 shard: tuple = (0, 1)):
        train_loader = Loader(train_source, batch_size, shuffle=True,
                              drop_last=True, seed=seed,
                              num_threads=num_threads, shard=shard,
                              accum_steps=accum_steps)
        super().__init__(task=DETECTION_TASK, model=model,
                         optimizer=optimizer, device=device,
                         train_loader=train_loader, val_loader=val_source,
                         test_loader=test_source, logger=logger, ckpt=ckpt,
                         epochs=epochs, accum_steps=accum_steps, seed=seed,
                         plateau=plateau, log_every=log_every)

    @property
    def val_source(self):
        return self.val_loader

    @property
    def test_source(self):
        return self.test_loader

    def _steps(self, accum_steps: int):
        return make_detection_full_step(accum_steps), None

    def train_epoch(self, epoch: int):
        meter = Throughput()
        it = prefetch_to_device(self.train_loader.epoch(epoch), self.device)
        aug_gen, model_gen = self.generators(epoch)
        last_loss = None
        for step, batch in enumerate(it):
            if self._stop_requested(step):
                self._check_preempted(epoch - 1)
            metrics = self.full_step(self.model, self.optimizer, batch,
                                     aug_gen, model_gen)
            meter.update(batch["image"].shape[0])
            if (step + 1) % self.log_every == 0:
                last_loss = float(metrics["loss"])
                self.logger.log({"epoch": epoch, "step": step + 1,
                                 "loss": last_loss, **meter.rates()})
        return last_loss

    def evaluate(self, source, epoch: int, split: str) -> float:
        res = evaluate_map(self.model, source,
                           batch_size=min(2, len(source)),
                           device=self.device)
        self.logger.log({"epoch": epoch, f"{split}_map": res["map"],
                         f"{split}_map50": res["map_50"]})
        return res["map"]
