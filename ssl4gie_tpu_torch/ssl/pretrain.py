"""SSL pretraining driver, MAE and MoCo v3 (port of
`ssl4gie_tpu/ssl/pretrain.py`, the counterpart of the vendored
`main_pretrain.py` / `main_moco.py`).

Recipes:
- MAE (`Models/mae/main_pretrain.py:165-200`, `engine_pretrain.py:42-60`):
  AdamW with betas (0.9, 0.95) and weight decay on the parameters with
  more than one dimension (timm's `add_weight_decay`), the base learning
  rate scaled by batch / 256, a per-step linear warmup then cosine decay to
  0, the norm-pix loss.
- MoCo v3 (`main_moco.py:224-230,420-434`): AdamW (the same grouping) or
  LARS on the same schedule, the cosine EMA momentum per step, the two
  BYOL crops; for vit_b and vit_s the patch projection stays at its random
  init (--stop-grad-conv1).
Both report the global gradient norm each step.

`make_mae_full_step` and `make_moco_full_step` compose the on-device
augmentation, the random draws and one train step. `build_pretraining`
assembles a `PretrainRun` (model, optimizer, loader, logger, slots) from a
`PretrainConfig`; `run_loop` runs its epochs one step at a time: per-epoch
images/s, a log line every `log_every` steps, the peak device memory per
epoch, the checkpoints after each epoch, and preemption (a signal
mid-epoch exits without saving, so the epoch replays from the last save;
after an epoch it exits after the save). The JAX package's `scan_steps`
superbatches are a TPU dispatch device and are not ported.

Randomness: each epoch one host generator, seeded from (seed, epoch),
draws the crops, the augmentation's factors and MAE's masking noise, which
go to the card from pinned memory without blocking; with the Loader's
(seed, epoch) order, a resumed or replayed epoch takes the same draws.

Checkpoints (`core/checkpoint.py`'s format: one `torch.save` file, written
to a temporary name, synced and renamed):
- `<ckpt_dir>/<framework>_<arch>.pt`, the export: the encoder's parameters
  (MoCo: backbone and projector; MAE: the whole model's) and the epoch;
- `<framework>_<arch>.resume.pt`, the full state: the model's state dict
  (MoCo: encoder, predictor, momentum encoder and their BatchNorm
  statistics), the optimizer's, the step and the epoch; a rerun resumes
  from it;
- the retained slots of the reference's history protocol, the full state
  as `checkpoint_%04d.pt` (MoCo, every epoch) or `checkpoint-%d.pt` (MAE,
  every 20 epochs and the last), 0-based; `keep_last` prunes them.

Over several processes the build lays out the mesh as the JAX package's
`run_pretraining` does (`ssl4gie_tpu/ssl/pretrain.py:120-157`): with
`--tensor-parallel` the ("data", "model") mesh checked against the head
counts of MAE's encoder and decoder or of the MoCo ViT (resnet50
refuses), else the ("data",) mesh; the model is placed (`parallel/tp.py:
make_place_fn`) before its optimizer is built, the MoCo momentum encoder
exactly as the encoder; each rank's Loader reads its part of the global
batch, whose draws (crops, factors, masking noise) are made for the
global batch (`distributed.draw_global`). The slots hold the full state,
gathered on every rank and written by rank 0; a preemption signal on any
rank stops every rank at the same step.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
import re
from typing import Callable

import numpy as np
import torch

from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
from ssl4gie_tpu_torch.core.config import (PretrainConfig, SSLFramework,
                                           compute_dtype)
from ssl4gie_tpu_torch.core.logger import (MetricsLogger, Throughput,
                                           peak_memory_mb)
from ssl4gie_tpu_torch.core.mesh import (axis_shard, axis_size,
                                         local_batch_size, make_mesh)
from ssl4gie_tpu_torch.core.preempt import Preempted, PreemptionGuard
from ssl4gie_tpu_torch.core.schedule import cosine_momentum
from ssl4gie_tpu_torch.core.train_state import make_adamw, set_lr
from ssl4gie_tpu_torch.core.trainer import epoch_seed
from ssl4gie_tpu_torch.data.augment import _on
from ssl4gie_tpu_torch.data.loader import (Loader, Source, _open_rgb,
                                           prefetch_to_device)
from ssl4gie_tpu_torch.data.ssl_augment import (mae_augment, moco_two_crops,
                                                sample_mae_params,
                                                sample_moco_params)
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.parallel import distributed as dist_lib
from ssl4gie_tpu_torch.parallel.tp import (grad_norm, make_place_fn,
                                           make_tp_mesh)
from ssl4gie_tpu_torch.ssl.lars import LARS
from ssl4gie_tpu_torch.ssl.mae import MAE, MAE_SIZES
from ssl4gie_tpu_torch.ssl.moco_v3 import (STOP_GRAD_ARCHS, VIT_PRESETS,
                                           MoCo, make_moco_train_step)


class UnlabeledSource(Source):
    """Hyperkvasir-unlabelled: image files decoded (RGB) and resized to a
    fixed `canvas`, so that the on-device crop has headroom."""

    def __init__(self, paths, canvas: int = 256):
        self.paths, self.canvas = list(paths), canvas

    def __len__(self):
        return len(self.paths)

    def get(self, i):
        return {"image": _open_rgb(self.paths[i], self.canvas)}


class SyntheticUnlabeled(Source):
    """Random uint8 canvases (the JAX package's `SyntheticUnlabeled`, same
    numpy draws)."""

    def __init__(self, n: int, canvas: int = 256, seed: int = 0):
        self.n, self.canvas, self.seed = n, canvas, seed

    def __len__(self):
        return self.n

    def get(self, i):
        rng = np.random.default_rng(self.seed * 9973 + i)
        return {"image": rng.integers(0, 256, (self.canvas, self.canvas, 3),
                                      dtype=np.uint8)}

    def batch(self, indices) -> dict:
        """The samples `indices` stacked into numpy arrays."""
        return {"image": np.stack([self.get(i)["image"] for i in indices])}


def discover_unlabeled(root: str) -> list[str]:
    """Every .jpg, .jpeg and .png under `root`, recursively, sorted."""
    paths = []
    for ext in ("*.jpg", "*.jpeg", "*.png"):
        paths += glob.glob(os.path.join(root, "**", ext), recursive=True)
    return sorted(paths)


def wd_mask(p: torch.Tensor) -> bool:
    """MAE's weight-decay grouping: decay only parameters with ndim > 1."""
    return p.ndim > 1


def make_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1), 0), as the JAX package builds it: linear from 0
    over the warmup (step 0 gives 0), then cosine to 0 over the remaining
    decay steps (the decay steps include the warmup). step -> lr."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        t = min(step - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def make_mae_optimizer(model: torch.nn.Module,
                       cfg: PretrainConfig) -> torch.optim.AdamW:
    """optax `adamw(schedule, b1=0.9, b2=0.95, weight_decay, mask=wd_mask)`;
    the step sets the learning rate from the schedule."""
    return make_adamw(model.parameters(), 0.0, b1=0.9, b2=0.95,
                      weight_decay=cfg.weight_decay, decay_mask=wd_mask)


def make_mae_train_step(schedule):
    """Returns train_step(model, optimizer, imgs, noise, step) -> {"loss",
    "grad_norm"}: the MAE loss of the normalized (B, S, S, 3) batch at the
    masking noise (B, L), its backward, and one AdamW step at the schedule's
    learning rate for `step` (0-based: the first step runs at schedule(0),
    as optax counts)."""

    def train_step(model, optimizer, imgs, noise, step: int):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _, _ = model(imgs, noise)
        loss.backward()
        dist_lib.finish_gradients(model)
        # optax.global_norm: the norm of all (float32) gradients together
        norm = grad_norm(model.parameters())
        set_lr(optimizer, schedule(step))
        optimizer.step()
        return {"loss": dist_lib.global_mean(loss.detach()),
                "grad_norm": norm}

    return train_step


def make_mae_full_step(schedule, img_size: int = 224):
    """Returns full_step(model, optimizer, img_u8, generator, step): draw
    the crop boxes, flips and masking noise from `generator` (on its
    device), run `mae_augment` on the uint8 (B, canvas, canvas, 3) batch,
    then take one train step."""
    step_fn = make_mae_train_step(schedule)

    def full_step(model, optimizer, img_u8, generator, step: int):
        B = img_u8.shape[0]
        params = dist_lib.draw_global(sample_mae_params, B, generator,
                                      canvas=img_u8.shape[1])
        imgs = mae_augment(img_u8, params, out_size=img_size)
        noise = _on({"noise": dist_lib.draw_global(
            dist_lib.unwrap(model).draw_noise, B, generator)},
            img_u8.device)["noise"]
        return step_fn(model, optimizer, imgs, noise, step)

    return full_step


def make_moco_full_step(total_steps: int, *, temperature: float = 0.2,
                        base_m: float = 0.99, schedule=None,
                        img_size: int = 224,
                        stop_grad_patch_embed: bool = False):
    """Returns full_step(moco, optimizer, img_u8, generator, step): draw
    both views' crops and factors from `generator`, run `moco_two_crops`
    on the uint8 (B, canvas, canvas, 3) batch, take the EMA momentum
    `cosine_momentum(step)` over `total_steps`, then one train step
    (`make_moco_train_step`)."""
    step_fn = make_moco_train_step(temperature, schedule,
                                   stop_grad_patch_embed)

    def full_step(moco, optimizer, img_u8, generator, step: int):
        params = dist_lib.draw_global(sample_moco_params, img_u8.shape[0],
                                      generator, canvas=img_u8.shape[1])
        x1, x2 = moco_two_crops(img_u8, params, out_size=img_size)
        m = cosine_momentum(step, base_m=base_m, total_steps=total_steps)
        return step_fn(moco, optimizer, x1, x2, m, step)

    return full_step


def _retained_save(cfg: PretrainConfig, tree: dict, epoch: int) -> None:
    """The reference's retained slots (the caller is the primary process):
    MoCo keeps every epoch as `checkpoint_%04d.pt` (0-based,
    `Models/moco_v3/main_moco.py:310-316`), MAE `checkpoint-%d.pt` when
    epoch0 % 20 == 0 or it is the last epoch (`Models/mae/
    main_pretrain.py:197-204`), so that any such epoch's encoder can seed a
    finetune; `save_every` sets the interval. `keep_last > 0` then prunes
    to the newest N numbered slots (beyond the reference)."""
    is_mae = cfg.framework == SSLFramework.MAE
    every = cfg.save_every or (20 if is_mae else 1)
    epoch0 = epoch - 1                     # the reference counts from 0
    if epoch0 % every != 0 and epoch != cfg.epochs:
        return
    name = ("checkpoint-%d" % epoch0) if is_mae else ("checkpoint_%04d"
                                                       % epoch0)
    ckpt_lib.CheckpointManager(cfg.ckpt_dir, name).save(tree)
    if cfg.keep_last > 0:
        pat = re.compile(r"^checkpoint-(\d+)\.pt$" if is_mae
                         else r"^checkpoint_(\d{4})\.pt$")
        slots = sorted((int(m.group(1)), f) for f in os.listdir(cfg.ckpt_dir)
                       if (m := pat.match(f)))
        for _, stale in slots[:-cfg.keep_last]:
            os.remove(os.path.join(cfg.ckpt_dir, stale))


@dataclasses.dataclass
class PretrainRun:
    """What `run_loop` drives: the model, its optimizer and full step
    (full_step(model, optimizer, img_u8, generator, step)), the loader, the
    logger, the export and resume slots, the optimizer-step count `step`
    and the first epoch to run. The export holds the model's parameters
    whose names start with `export_prefix`, without it."""
    cfg: PretrainConfig
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    full_step: Callable
    export_prefix: str
    loader: Loader
    logger: MetricsLogger
    device: torch.device
    ckpt: ckpt_lib.CheckpointManager
    resume_ckpt: ckpt_lib.CheckpointManager
    step: int = 0
    start_epoch: int = 1

    def state_tree(self, epoch: int) -> dict:
        """A host copy of the full state, `epoch` epochs complete (whole
        on rank 0 of a placed model; every rank calls it)."""
        model_sd, optim_sd = ckpt_lib.state_dicts(self.model, self.optimizer)
        return {"model": model_sd, "optimizer": optim_sd,
                "step": self.step, "meta": {"epoch": epoch}}

    def export(self, epoch: int, model_state: dict | None = None) -> None:
        """Write the export of `epoch` (what `--checkpoint` loads): the
        parameters under `export_prefix`, from `model_state` (a host copy
        of the model's full state dict) or the model (then every rank
        calls it)."""
        if model_state is None:
            model_state = ckpt_lib.state_dicts(self.model)[0]
        if not ckpt_lib.is_primary():
            return
        n = len(self.export_prefix)
        self.ckpt.save({"params": {
            name[n:]: model_state[name]
            for name, _ in dist_lib.unwrap(self.model).named_parameters()
            if name.startswith(self.export_prefix)},
            "meta": {"epoch": epoch}})

    def save(self, epoch: int) -> None:
        """The export, the resume slot and the retained slot of `epoch`,
        written by rank 0; every rank calls it and waits for the writes."""
        tree = self.state_tree(epoch)
        if ckpt_lib.is_primary():
            self.export(epoch, tree["model"])
            self.resume_ckpt.save(tree)
            _retained_save(self.cfg, tree, epoch)
        dist_lib.barrier()

    def maybe_resume(self) -> None:
        """Restore the resume slot, if there is one, and continue after its
        epoch."""
        if not self.resume_ckpt.exists():
            return
        tree = self.resume_ckpt.restore(map_location=self.device)
        ckpt_lib.load_state_dicts(self.model, self.optimizer, tree["model"],
                                  tree["optimizer"])
        self.step = int(tree["step"])
        self.start_epoch = int(tree["meta"]["epoch"]) + 1
        name = "MAE" if self.cfg.framework == SSLFramework.MAE else "MoCo"
        self.logger.log({"resumed_from_epoch": self.start_epoch - 1},
                        echo=f"resuming {name} pretraining at epoch "
                             f"{self.start_epoch}")


def _pretrain_mesh(cfg: PretrainConfig):
    """(mesh, TP active) of a pretraining run, with the JAX package's
    checks (`ssl4gie_tpu/ssl/pretrain.py:120-157`) and the batch's
    divisibility by the data size; the mesh is None for one process."""
    tp, device = cfg.runtime.tensor_parallel, cfg.runtime.device
    if tp > 1:
        if cfg.framework == SSLFramework.MAE:
            size = dict(MAE_SIZES.get(cfg.architecture.value, {}),
                        **cfg.model_kwargs)
            heads = (size.get("num_heads", 12),
                     size.get("decoder_num_heads", 16))
        else:
            if cfg.architecture.value not in VIT_PRESETS:
                raise ValueError("--tensor-parallel requires a ViT "
                                 "architecture; use --fsdp or pure data "
                                 "parallelism for resnet50")
            heads = (VIT_PRESETS[cfg.architecture.value]["num_heads"],)
        mesh = make_tp_mesh(tp, *heads, device=device)
    else:
        mesh = make_mesh(device=device)
    local_batch_size(cfg.batch_size, mesh)
    return mesh, axis_size(mesh, "model") > 1


def build_pretraining(cfg: PretrainConfig) -> PretrainRun:
    """The model (random weights from the seed, `cfg.runtime.device`, the
    compute dtype), optimizer, full step, loader, logger and slots of
    `cfg`. `cfg.model_kwargs` overrides the MAE size preset or passes
    `MoCo`'s `stage_sizes` (tests narrow the models). Over several
    processes: the mesh, the placement and each rank's part of the batch
    (see the module's docstring)."""
    device = default_device(cfg.runtime.device)
    dtype = compute_dtype(cfg.runtime)
    fw, arch = cfg.framework, cfg.architecture.value
    mesh, tp = _pretrain_mesh(cfg)
    place = make_place_fn(mesh, tp=tp, fsdp=cfg.runtime.fsdp)
    src = (SyntheticUnlabeled(cfg.data.synthetic_size) if cfg.data.synthetic
           else UnlabeledSource(discover_unlabeled(cfg.data.data_root)))
    loader = Loader(src, cfg.batch_size, shuffle=True, drop_last=True,
                    seed=cfg.runtime.seed, num_threads=cfg.data.num_workers,
                    shard=axis_shard(mesh))
    steps_per_epoch = len(loader)
    total_steps = steps_per_epoch * cfg.epochs
    schedule = make_schedule(cfg.effective_lr(),
                             steps_per_epoch * cfg.warmup_epochs, total_steps)
    gen = torch.Generator().manual_seed(cfg.runtime.seed)

    if fw == SSLFramework.MAE:
        size = dict(MAE_SIZES[arch], **cfg.model_kwargs)
        model = place(MAE(img_size=cfg.img_size,
                          norm_pix_loss=cfg.norm_pix_loss,
                          mask_ratio=cfg.mask_ratio, dtype=dtype,
                          generator=gen, device=device, **size))
        optimizer = make_mae_optimizer(model, cfg)
        full_step = make_mae_full_step(schedule, cfg.img_size)
        export_prefix = ""
    else:
        model = place(MoCo(arch, cfg.moco_dim, cfg.moco_mlp_dim, dtype,
                           generator=gen, device=device, **cfg.model_kwargs))
        params = dist_lib.unwrap(model).trained_parameters()
        if cfg.optimizer == "lars":
            # LARS keeps its own step count and reads the schedule itself
            optimizer = LARS(params, lr=schedule,
                             weight_decay=cfg.weight_decay)
        else:
            optimizer = make_adamw(params, 0.0, b1=0.9, b2=0.95,
                                   weight_decay=cfg.weight_decay,
                                   decay_mask=wd_mask)
        full_step = make_moco_full_step(
            total_steps, temperature=cfg.moco_temperature,
            base_m=cfg.moco_momentum,
            schedule=None if cfg.optimizer == "lars" else schedule,
            img_size=cfg.img_size,
            stop_grad_patch_embed=(cfg.moco_stop_grad_patch_embed
                                   and arch in STOP_GRAD_ARCHS))
        export_prefix = "encoder."
    name = f"{fw.value}_{arch}"
    return PretrainRun(
        cfg=cfg, model=model, optimizer=optimizer, full_step=full_step,
        export_prefix=export_prefix, loader=loader,
        logger=MetricsLogger(cfg.ckpt_dir, f"pretrain_{name}",
                             tb=cfg.runtime.tensorboard),
        device=device, ckpt=ckpt_lib.CheckpointManager(cfg.ckpt_dir, name),
        resume_ckpt=ckpt_lib.CheckpointManager(cfg.ckpt_dir,
                                               name + ".resume"))


def run_loop(run: PretrainRun) -> None:
    """Epochs `run.start_epoch`..`cfg.epochs`, one step at a time (see the
    module's docstring)."""
    cfg, log_every = run.cfg, run.cfg.runtime.log_every
    n_steps = len(run.loader)
    with PreemptionGuard() as guard:
        for epoch in range(run.start_epoch, cfg.epochs + 1):
            meter = Throughput()    # per-epoch rates (epoch 1: warm-up)
            gen = torch.Generator().manual_seed(
                epoch_seed(cfg.runtime.seed, epoch))
            batches = prefetch_to_device(run.loader.epoch(epoch), run.device)
            for i, batch in enumerate(batches):
                if dist_lib.poll_stop(guard.should_stop, i, log_every):
                    # mid-epoch: no save; the last epoch's slot is the
                    # requeue state and this epoch replays
                    run.logger.log({"preempted_in_epoch": epoch},
                                   echo=f"preemption signal mid-epoch "
                                        f"{epoch}: exiting for requeue, "
                                        f"epoch {epoch} replays from the "
                                        "last .resume state")
                    raise Preempted()
                img = batch["image"]
                out = run.full_step(run.model, run.optimizer, img, gen,
                                    run.step)
                run.step += 1
                meter.update(img.shape[0])
                if (i + 1) % log_every == 0:
                    run.logger.log({"epoch": epoch, "step": i + 1,
                                    "loss": float(out["loss"]),
                                    "grad_norm": float(out["grad_norm"]),
                                    **meter.rates(n_steps - (i + 1))})
            run.save(epoch)
            mem = peak_memory_mb(run.device)
            if mem is not None:
                run.logger.log({"epoch": epoch, "max_mem_mb": mem})
            if dist_lib.poll_stop(guard.should_stop):
                run.logger.log({"preempted_after_epoch": epoch},
                               echo=f"preemption signal: checkpointed epoch "
                                    f"{epoch}, exiting for requeue")
                raise Preempted()


def run_pretraining(cfg: PretrainConfig) -> str:
    """Build, resume when a resume slot exists, run; returns the export
    slot's path."""
    run = build_pretraining(cfg)
    run.maybe_resume()
    run_loop(run)
    return run.ckpt.path
