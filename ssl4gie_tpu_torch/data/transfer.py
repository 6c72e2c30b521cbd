"""MoCo v3's transfer-learning datasets (CIFAR-10/100, Oxford Flowers-102,
Oxford-IIIT Pets) and their train and eval transforms (port of
`ssl4gie_tpu/data/transfer.py`; the reference's
`Models/moco_v3/transfer/datasets.py:34-74`, `oxford_flowers_dataset.py:
20-67`, `oxford_pets_dataset.py:19-66`).

The host decodes to a fixed shape: CIFAR stays 32 x 32; Flowers and Pets
are resized on their shorter side to `int(256 / 224 * input_size)` and
centre-cropped square at load time, the reference's eval Resize +
CenterCrop geometry. The transforms then run batched on the device:
`transfer_train_batch` is RandomResizedCrop(scale 0.05-1) + horizontal
flip + ImageNet normalize (`datasets.py:19-24`), its draws split off in
`sample_transfer_params`; `transfer_eval_batch` is the bilinear resize up
to the load size (CIFAR), the centre crop and normalize
(`datasets.py:25-29`). The train crop samples from the centre-cropped
image rather than the full original, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
import torch

from ssl4gie_tpu_torch.data.augment import _on, normalize
from ssl4gie_tpu_torch.data.loader import Source
from ssl4gie_tpu_torch.data.ssl_augment import (_sample_crop, _sampler,
                                                random_resized_crop)
from ssl4gie_tpu_torch.ops.resize import resize_bilinear

TRANSFER_CROP_SCALE = (0.05, 1.0)


def _load_size(input_size: int) -> int:
    # `transforms.Resize(int((256 / 224) * args.input_size))` (datasets.py:26)
    return int((256 / 224) * input_size)


# --------------------------------------------------------------- host decode

def _open_rgb_short_side(path: str, size: int) -> np.ndarray:
    """torchvision Resize(size) (shorter side, bilinear; the long side
    truncated) + CenterCrop(size) (offset rounded), as (size, size, 3)
    uint8."""
    from PIL import Image
    im = Image.open(path)
    if im.mode != "RGB":
        im = im.convert("RGB")
    w, h = im.size
    if w <= h:
        nw, nh = size, max(size, int(size * h / w))
    else:
        nh, nw = size, max(size, int(size * w / h))
    im = im.resize((nw, nh), Image.BILINEAR)
    left = int(round((nw - size) / 2))
    top = int(round((nh - size) / 2))
    im = im.crop((left, top, left + size, top + size))
    return np.asarray(im, dtype=np.uint8)


# ------------------------------------------------------------------- sources

class CIFARSource(Source):
    """CIFAR-10/100 from the standard python pickle batches, the files
    torchvision's `datasets.CIFAR10/100` read (`datasets.py:46-57`):
    `cifar-10-batches-py/{data_batch_1..5,test_batch}` or
    `cifar-100-python/{train,test}` with `fine_labels`. Nothing is
    downloaded."""

    def __init__(self, root: str, train: bool, variant: str = "cifar10"):
        if variant == "cifar10":
            base = os.path.join(root, "cifar-10-batches-py")
            files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                     else ["test_batch"])
            label_key = b"labels"
        else:
            base = os.path.join(root, "cifar-100-python")
            files = ["train" if train else "test"]
            label_key = b"fine_labels"
        datas, labels = [], []
        for name in files:
            with open(os.path.join(base, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(np.asarray(d[b"data"], np.uint8))
            labels.extend(d[label_key])
        # (N, 3072) CHW-flat -> (N, 32, 32, 3) HWC
        self.images = (np.concatenate(datas)
                       .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy())
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.labels)

    def get(self, i):
        return {"image": self.images[i], "label": np.int32(self.labels[i])}


class FlowersSource(Source):
    """Oxford Flowers-102: `jpg/image_%05d.jpg`, 1-based labels in
    `imagelabels.mat`, trainval = trnid + valid and test = tstid from
    `setid.mat`."""

    def __init__(self, root: str, train: bool, input_size: int = 224):
        import scipy.io
        self.image_folder = os.path.join(root, "jpg")
        labels = scipy.io.loadmat(os.path.join(root, "imagelabels.mat"))[
            "labels"][0]
        setid = scipy.io.loadmat(os.path.join(root, "setid.mat"))
        ids = (np.concatenate([setid["trnid"][0], setid["valid"][0]])
               if train else setid["tstid"][0])
        self.ids = np.asarray(ids, np.int64)
        self.labels = np.asarray(labels, np.int64)
        self.size = _load_size(input_size)

    def __len__(self):
        return len(self.ids)

    def get(self, i):
        idx = int(self.ids[i])
        path = os.path.join(self.image_folder, "image_%05d.jpg" % idx)
        return {"image": _open_rgb_short_side(path, self.size),
                "label": np.int32(self.labels[idx - 1] - 1)}


class PetsSource(Source):
    """Oxford-IIIT Pets: split lists `annotations/{trainval,test}.txt`
    ("name label species id", 1-based labels), images `images/<name>.jpg`."""

    def __init__(self, root: str, train: bool, input_size: int = 224):
        split = "trainval.txt" if train else "test.txt"
        with open(os.path.join(root, "annotations", split)) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.names, self.labels = [], []
        for ln in lines:
            name, label = ln.split(" ")[:2]
            self.names.append(name)
            self.labels.append(int(label) - 1)
        self.image_dir = os.path.join(root, "images")
        self.size = _load_size(input_size)

    def __len__(self):
        return len(self.names)

    def get(self, i):
        path = os.path.join(self.image_dir, self.names[i] + ".jpg")
        return {"image": _open_rgb_short_side(path, self.size),
                "label": np.int32(self.labels[i])}


def build_transfer_dataset(name: str, root: str, train: bool,
                           input_size: int = 224) -> Tuple[Source, int]:
    """(source, nb_classes), `datasets.py:34-74`'s `build_dataset`,
    imagenet refused as there."""
    if name == "cifar10":
        return CIFARSource(root, train, "cifar10"), 10
    if name == "cifar100":
        return CIFARSource(root, train, "cifar100"), 100
    if name == "flowers":
        return FlowersSource(root, train, input_size), 102
    if name == "pets":
        return PetsSource(root, train, input_size), 37
    raise NotImplementedError(
        "Only [cifar10, cifar100, flowers, pets] are supported; for imagenet "
        "end-to-end finetuning use the main classification task.")


# --------------------------------------------------------- device transforms

def sample_transfer_params(B: int, H: int, generator: torch.Generator
                           ) -> dict:
    """The train transform's crop boxes (area U[0.05, 1] of an H x H
    image) and horizontal flips (U[0, 1) > 0.5)."""
    uniform = _sampler(B, generator)
    return {"box": _sample_crop(uniform, TRANSFER_CROP_SCALE, H),
            "flip": uniform(0.0, 1.0) > 0.5}


def transfer_train_batch(img_u8: torch.Tensor, params: dict,
                         input_size: int = 224) -> torch.Tensor:
    """RandomResizedCrop((S, S), scale=(0.05, 1.0)) + RandomHorizontalFlip
    + ImageNet normalize at the draws of `params`, float32."""
    p = _on(params, img_u8.device)
    img = random_resized_crop(img_u8.to(torch.float32) / 255.0, p["box"],
                              input_size)
    return normalize(torch.where(p["flip"].reshape(-1, 1, 1, 1),
                                 img.flip(2), img))


def transfer_eval_batch(img_u8: torch.Tensor,
                        input_size: int = 224) -> torch.Tensor:
    """Resize(int(256/224 * S)) + CenterCrop(S) + normalize, float32: a
    batch not at the load size (CIFAR) is resized bilinearly (half-pixel
    centers, torchvision's Resize), then the centre crop."""
    img = img_u8.to(torch.float32) / 255.0
    load = _load_size(input_size)
    if tuple(img.shape[1:3]) != (load, load):
        img = resize_bilinear(img, load, load)
    off = int(round((load - input_size) / 2))
    return normalize(img[:, off:off + input_size, off:off + input_size])
