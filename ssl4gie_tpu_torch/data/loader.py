"""Host-side data loading (port of `ssl4gie_tpu/data/loader.py`): threaded
decode -> stacked numpy batches -> a double-buffered copy to the device.

The host only decodes and resizes (PIL, as the reference's
`Image.open(...).resize((224, 224))`); the augmentation runs on the device
(`data/augment.py`). `Loader` gives the JAX package's batches in its order:
one permutation per epoch from `np.random.default_rng((seed, epoch))`, the
same `drop_last`. `prefetch_to_device` keeps two batches in flight: on the
card each uint8 batch is copied from pinned memory on a side stream,
without blocking the host. PIL is imported inside the file sources only,
so that the synthetic source needs no PIL. `SSL4GIE_NATIVE_LOADER=1`
decodes and resizes through the port's C++ loader
(`data/native_loader.py`, libjpeg/libpng with the GIL released) instead
of PIL, as the JAX package's switch does.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ssl4gie_tpu_torch.parallel.distributed import local_rows


class Source:
    """Indexable sample source yielding dicts of numpy arrays."""

    def __len__(self):
        raise NotImplementedError

    def get(self, index: int) -> dict:
        raise NotImplementedError


_native = None
_native_lock = threading.Lock()


def _native_loader():
    """The process's `NativeBatchLoader`, made (and the library built) at
    first use; a failed build raises."""
    global _native
    with _native_lock:
        if _native is None:
            from ssl4gie_tpu_torch.data.native_loader import NativeBatchLoader
            _native = NativeBatchLoader()
        return _native


def _open_rgb(path: str, size: Optional[int], make_square: bool = False):
    if size is not None and os.environ.get("SSL4GIE_NATIVE_LOADER") == "1":
        loader = _native_loader()   # a failed build or load raises
        try:
            return loader.load([path], size, make_square)[0]
        except IOError:
            pass   # a format it does not decode (16-bit TIFF): PIL, as JAX
    from PIL import Image
    im = Image.open(path)
    if im.mode != "RGB":
        im = im.convert("RGB")
    if make_square:
        im = _pil_make_square(im, fill=(0, 0, 0), mode="RGB")
    if size is not None:
        im = im.resize((size, size))
    return np.asarray(im, dtype=np.uint8)


def _pil_make_square(im, fill, mode):
    from PIL import Image
    x, y = im.size
    size = max(x, y)
    new = Image.new(mode, (size, size), fill)
    new.paste(im, (int((size - x) / 2), int((size - y) / 2)))
    return new


class ClassificationSource(Source):
    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 size: int = 224):
        self.paths, self.labels, self.size = list(paths), list(labels), size

    def __len__(self):
        return len(self.paths)

    def get(self, i):
        return {"image": _open_rgb(self.paths[i], self.size),
                "label": np.int32(self.labels[i])}


class SegmentationSource(Source):
    """Images resized to `size`; masks too, or kept at their native size
    (`native_target`, the held-out evaluation's)."""

    def __init__(self, paths, mask_paths, size: int = 224,
                 native_target: bool = False):
        self.paths, self.mask_paths = list(paths), list(mask_paths)
        self.size, self.native_target = size, native_target

    def __len__(self):
        return len(self.paths)

    def get(self, i):
        from PIL import Image
        img = _open_rgb(self.paths[i], self.size)
        m = Image.open(self.mask_paths[i])
        if not self.native_target:
            m = m.resize((self.size, self.size))
        m = m.convert("L")   # torchvision Grayscale on the mask
        mask = (np.asarray(m, dtype=np.float32) / 255.0)[..., None]
        return {"image": img, "mask": mask}


class DepthSource(Source):
    """C3VD frames and 16-bit depth maps, both made square (black borders)
    and resized to `size`; `with_native` adds the depth map at its native
    size (the held-out evaluation's)."""

    def __init__(self, paths, depth_paths, size: int = 224,
                 with_native: bool = False):
        self.paths, self.depth_paths = list(paths), list(depth_paths)
        self.size, self.with_native = size, with_native

    def __len__(self):
        return len(self.paths)

    def get(self, i):
        from PIL import Image
        img = _open_rgb(self.paths[i], self.size, make_square=True)
        d = Image.open(self.depth_paths[i])
        native = np.asarray(d, dtype=np.float32) / 65535.0
        ds = _pil_make_square(d, fill=0, mode="I;16").resize((self.size,
                                                              self.size))
        depth = (np.asarray(ds, dtype=np.float32) / 65535.0)[..., None]
        out = {"image": img, "depth": depth}
        if self.with_native:
            out["native_depth"] = native[..., None]
        return out


class SyntheticSource(Source):
    """Deterministic random data for tests and benchmarks, no files: the
    JAX package's bytes for the same (n, size, task, n_class, seed).
    `with_native` adds a depth sample's map again as its native map (the
    held-out depth evaluation's key; the JAX package's synthetic source has
    none, so its evaluation of synthetic depth raises)."""

    def __init__(self, n: int, size: int = 224, task: str = "classification",
                 n_class: int = 6, seed: int = 0, with_native: bool = False):
        self.n, self.size, self.task = n, size, task
        self.n_class, self.seed, self.with_native = n_class, seed, with_native

    def __len__(self):
        return self.n

    def get(self, i):
        rng = np.random.default_rng(self.seed * 100003 + i)
        img = rng.integers(0, 256, size=(self.size, self.size, 3),
                           dtype=np.uint8)
        if self.task == "classification":
            return {"image": img,
                    "label": np.int32(rng.integers(0, self.n_class))}
        if self.task == "segmentation":
            yy, xx = np.mgrid[:self.size, :self.size]
            m = max(self.size // 4, 1)
            cy, cx = rng.integers(m, self.size - m, 2)
            r = rng.integers(max(self.size // 16, 1), max(self.size // 4, 2))
            mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(
                np.float32)
            return {"image": img, "mask": mask[..., None]}
        if self.task == "depth":
            depth = rng.uniform(0.05, 1.0, size=(self.size, self.size,
                                                 1)).astype(np.float32)
            if self.with_native:
                return {"image": img, "depth": depth,
                        "native_depth": depth.copy()}
            return {"image": img, "depth": depth}
        raise ValueError(self.task)


class Loader:
    """Deterministic epoch-shuffled batcher with threaded decode: one
    permutation per epoch seeded by (seed, epoch), as the JAX package's.

    `shard` = (i, n) splits every batch over n data-parallel ranks, of
    which this one is i, and the Loader reads only its rows, from the same
    permutation: a training batch (`drop_last`) its `local_rows` (with
    `accum_steps` microbatches, its part of each), an evaluation batch the
    i-th of n contiguous parts (`np.array_split`; the ragged tail stays
    unpadded). A rank whose part of a batch is empty gets that batch's
    last row under the key "padding", so that it still runs the batch's
    collectives; its result is dropped."""

    def __init__(self, source: Source, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 42,
                 num_threads: int = 8, shard: tuple = (0, 1),
                 accum_steps: int = 1):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = tuple(shard)
        self.accum_steps = accum_steps
        self.pool = cf.ThreadPoolExecutor(max_workers=num_threads)

    def __len__(self):
        n = len(self.source)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        i, n = self.shard
        if n == 1:
            return idx
        if self.drop_last:
            return idx[local_rows(len(idx), self.accum_steps, self.shard)]
        return np.array_split(idx, n)[i]

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        n = len(self.source)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch_idx)).permutation(n)
        else:
            order = np.arange(n)
        for b in range(len(self)):
            batch = order[b * self.batch_size:(b + 1) * self.batch_size]
            idx = self._rows(batch)
            padding = len(idx) == 0
            if padding:
                idx = batch[-1:]
            samples = list(self.pool.map(self.source.get, idx))
            out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            if padding:
                out["padding"] = np.ones(1, bool)
            yield out


PREFETCH = 2   # batches in flight ahead of the one the consumer holds


def prefetch_to_device(it: Iterator[dict], device) -> Iterator[dict]:
    """Yield the batches of `it` as tensors on `device`, PREFETCH batches
    ahead. On the card each array is copied from pinned memory on a side
    stream (`non_blocking`, so the host goes on decoding); the consumer's
    stream waits for that batch's copies, and the tensors are recorded on
    it so that their memory is not reused before it has read them. On the
    CPU the arrays are wrapped as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(v).pin_memory().to(device,
                                                          non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take():
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for batch in it:
        queue.append(put(batch))
        if len(queue) > PREFETCH:
            yield take()
    while queue:
        yield take()
