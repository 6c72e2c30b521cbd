"""The training engine (port of `ssl4gie_tpu/core/trainer.py`).

One train step is the forward, the loss, the backward over `accum_steps`
microbatches with averaged gradients (a Python loop where the JAX package
scans), then the optimizer step. The model runs in train mode: BatchNorm
statistics update once per microbatch, as the JAX package threads its
batch_stats through the scan, and dropout and stochastic depth draw from
the step's generator. `make_full_step` composes the on-device augmentation
(classification, segmentation or depth) and that step, as the JAX
package's bench steps do.

`Trainer` runs the reference's finetune protocol around that step:
per-epoch validation and test, ReduceLROnPlateau on the validation metric,
best-val checkpointing with resume, preemption (save and exit for
requeue), and images/s and step-time logging. It follows the JAX Trainer
(`ssl4gie_tpu/core/trainer.py:115-434`) with these differences:
- randomness: per epoch, a host `torch.Generator` seeded from (seed,
  epoch) draws the augmentation's factors (a card generator would sync the
  device at each `randperm(...).tolist()`), and the model's dropout and
  stochastic depth draw from it too, or, on the card for a task with
  dropout, from a card generator seeded the same way (a host draw of a
  dropout mask is as large as the activation). A resumed run replays the
  same epochs, as under JAX's `fold_in(root_key, epoch)`;
- evaluation runs each batch at its own size, the ragged tail included:
  eager torch needs no static shape, and the masked sums of the JAX
  package's padded batches are the sums over the real rows;
- the only per-step host sync is the loss read every `log_every` steps.
Under data parallelism (a model placed by `parallel/tp.py:make_place_fn`)
each rank trains on its rows of the global batch (`Loader(shard=)`), the
samplers draw for the global batch and each rank keeps its rows
(`distributed.draw_global`), so W ranks draw what one process draws; the
backward reduces the gradients only after the last microbatch (DDP's
`no_sync`, FSDP's gradient sync), the logged loss is the global one,
evaluation gathers every rank's predictions or sums, so that the plateau
and the best-val choice see one number on every rank, a preemption signal
on any rank stops all of them at the same step, and the checkpoints hold
the full state (`core/checkpoint.py:state_dicts`), written by rank 0.
`aug_mode="none"` normalizes the uint8 batch without augmentation, as
the JAX Trainer's. With `profile_dir` the first epoch's steps 5-10 are
recorded with `torch.profiler` into it (`core/spans.py:StepTrace`), as the
JAX Trainer traces them; the steps run under the spans of `core/spans.py`.
With `SSL4GIE_HOST_AUG=1` a classification epoch is augmented on the host
by the C++ loader (`data/native_loader.py:augment_classification`, one
seed a step from the epoch's generator) before the copy to the device, as
the JAX Trainer's switch; a failed build of that library raises. A task
with its own `aug_fn` or a `mixup_fn` (the SSL finetune recipes) always
augments on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
from ssl4gie_tpu_torch.core.logger import (MetricsLogger, Throughput,
                                           peak_memory_mb)
from ssl4gie_tpu_torch.core.preempt import Preempted, PreemptionGuard
from ssl4gie_tpu_torch.core.schedule import ReduceLROnPlateau
from ssl4gie_tpu_torch.core.spans import StepTrace, span
from ssl4gie_tpu_torch.core.train_state import (apply_gradients, get_lr,
                                                set_lr)
from ssl4gie_tpu_torch.data.augment import (apply_classification, apply_depth,
                                            apply_segmentation, eval_batch,
                                            exact_affine_enabled,
                                            per_image_jitter_enabled,
                                            sample_classification_params,
                                            sample_depth_params,
                                            sample_segmentation_params)
from ssl4gie_tpu_torch.data.loader import prefetch_to_device
from ssl4gie_tpu_torch.parallel import distributed as dist_lib


@dataclasses.dataclass
class TaskDefinition:
    """What a task contributes to the engine."""
    name: str
    aug_mode: str                # classification | segmentation | depth | none
    target_key: str                     # label | mask | depth
    loss_fn: Callable                   # (outputs, targets) -> scalar loss
    # batch_metric: (outputs, targets) -> per-sample (numerator,
    # denominator); accumulate_preds: unused (argmax, then eval_finalize)
    eval_metric_fn: Optional[Callable] = None
    eval_kind: str = "batch_metric"     # batch_metric | accumulate_preds
    select_mode: str = "max"            # plateau/selection direction
    has_dropout: bool = False
    # a replacement train transform, (img_u8, generator) -> normalized
    # float32 image, over the aug_mode stack: the probe's RRC + hflip or
    # the timm --aa/--reprob stack (`data/randaug.py`), drawing for the
    # global batch
    aug_fn: Optional[Callable] = None
    # a train-time mixer after the augmentation, (img, targets, generator)
    # -> (img, targets): label smoothing and mixup/cutmix
    # (`Models/mae/main_finetune.py:219-226`); its targets are what loss_fn
    # takes
    mixup_fn: Optional[Callable] = None


def make_train_step(task: TaskDefinition, accum_steps: int = 1):
    """Returns train_step(model, optimizer, batch, generator=None) ->
    {"loss": scalar tensor}. `batch` holds "image" and `task.target_key`
    with the batch on dim 0, divisible by `accum_steps`; `generator` drives
    any sampling inside the model (stochastic depth, dropout). `model` may
    be placed (DDP, FSDP, TP): its gradients are reduced over the data
    group in the last microbatch's backward, and the loss returned is the
    global batch's."""

    def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   batch: dict, generator: torch.Generator | None = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images, targets = batch["image"], batch[task.target_key]
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        mb = images.shape[0] // accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32, device=images.device)
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            with dist_lib.gradient_sync(model, i == accum_steps - 1):
                with span("ssl4gie.forward"):
                    loss = task.loss_fn(model(images[sl], generator),
                                        targets[sl])
                with span("ssl4gie.backward"):
                    loss.backward()    # sums the microbatch gradients
            loss_sum += loss.detach()
        with span("ssl4gie.backward"):
            dist_lib.finish_gradients(model)
            if accum_steps > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
        with span("ssl4gie.optimizer"):
            apply_gradients(optimizer)
        return {"loss": dist_lib.global_mean(loss_sum / accum_steps)}

    return train_step


def make_full_step(task: TaskDefinition, accum_steps: int = 1,
                   exact: Optional[bool] = None,
                   per_image_jitter: Optional[bool] = None):
    """Returns full_step(model, optimizer, img_u8, targets, generator,
    model_generator=None): sample the augmentation from `generator`,
    augment the uint8 batch (and, for segmentation and depth, its (B, H, W,
    1) mask or depth map with it) on its device (or run the task's
    `aug_fn`), mix images and targets by its `mixup_fn` (drawing from
    `generator` after the augmentation), then take one train step,
    whose dropout and stochastic depth draw from `model_generator` (by
    default `generator`). `exact` (the one-pass warp) and
    `per_image_jitter` default to `SSL4GIE_EXACT_AFFINE` and
    `SSL4GIE_PER_IMAGE_JITTER`, read here. `aug_mode="none"` only
    normalizes. Under data parallelism the samplers draw for the global
    batch and keep this rank's rows."""
    if task.aug_fn is None and task.aug_mode not in (
            "classification", "segmentation", "depth", "none"):
        raise NotImplementedError(f"aug_mode {task.aug_mode!r}: only "
                                  "classification, segmentation, depth and "
                                  "none are ported")
    exact = exact_affine_enabled() if exact is None else exact
    per_image = (per_image_jitter_enabled() if per_image_jitter is None
                 else per_image_jitter)
    step = make_train_step(task, accum_steps)

    def augment(img_u8, targets, generator):
        B = img_u8.shape[0]
        draw = functools.partial(dist_lib.draw_global,
                                 accum_steps=accum_steps)
        if task.aug_fn is not None:
            img = task.aug_fn(img_u8, generator)
        elif task.aug_mode == "none":
            img = eval_batch(img_u8)
        elif task.aug_mode == "segmentation":
            params = draw(sample_segmentation_params, B, img_u8.shape[1],
                          generator, per_image)
            img, targets = apply_segmentation(img_u8, targets, params, exact)
        elif task.aug_mode == "depth":
            params = draw(sample_depth_params, B, generator, per_image)
            img, targets = apply_depth(img_u8, targets, params)
        else:
            params = draw(sample_classification_params, B, generator,
                          per_image)
            img = apply_classification(img_u8, params, exact)
        if task.mixup_fn is not None:
            img, targets = task.mixup_fn(img, targets, generator)
        return img, targets

    def full_step(model, optimizer, img_u8, targets, generator,
                  model_generator=None):
        with span("ssl4gie.step"):
            with span("ssl4gie.augment"):
                img, targets = augment(img_u8, targets, generator)
            return step(model, optimizer,
                        {"image": img, task.target_key: targets},
                        generator if model_generator is None
                        else model_generator)

    return full_step


def make_eval_step(task: TaskDefinition):
    """Returns eval_step(model, batch) over a batch of any size, without
    gradients: argmax predictions (B,) for `accumulate_preds` tasks, else
    the batch's sums of `eval_metric_fn`'s numerators and denominators,
    two float32 scalars on the device (the JAX package's masked sums)."""

    @torch.no_grad()
    def eval_step(model, batch):
        outputs = model(batch["image"])
        if task.eval_kind == "accumulate_preds":
            return torch.argmax(outputs, dim=-1)
        num, den = task.eval_metric_fn(outputs, batch[task.target_key])
        return num.sum(), den.sum()

    return eval_step


def epoch_seed(seed: int, epoch: int) -> int:
    """The generators' seed for `epoch` of a run seeded `seed`."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0])


class Trainer:
    def __init__(self, *, task: TaskDefinition, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, device,
                 train_loader, val_loader, test_loader,
                 logger: MetricsLogger, ckpt: ckpt_lib.CheckpointManager,
                 epochs: int, accum_steps: int = 1, seed: int = 42,
                 plateau: Optional[ReduceLROnPlateau] = None,
                 eval_finalize: Optional[Callable] = None,
                 log_every: int = 10, profile_dir: Optional[str] = None):
        self.task = task
        self.model = model
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.logger = logger
        self.ckpt = ckpt
        self.epochs = epochs
        self.seed = seed
        self.plateau = plateau
        self.eval_finalize = eval_finalize   # meanF1 over accumulated preds
        self.log_every = log_every
        self.accum_steps = accum_steps
        self.profile_dir = profile_dir    # steps 5-10 of the first epoch
        self.full_step, self.eval_step = self._steps(accum_steps)
        self._native_aug_pool = None
        self.start_epoch = 1
        self.best_val: Optional[float] = None
        # sibling slot for preemption saves: the best-val slot keeps the
        # BEST weights (evaluate loads it), so the requeue state lives next
        # to it and maybe_resume picks whichever is newer
        self.preempt_ckpt = ckpt_lib.CheckpointManager(
            ckpt.directory, ckpt.name + ".preempt")
        self._guard: Optional[PreemptionGuard] = None
        # host snapshot taken at each epoch BOUNDARY: a mid-epoch preemption
        # saves it (not the half-updated state), so the requeued run replays
        # the interrupted epoch from clean state
        self._boundary_snapshot = None
        self._preempt_slot_epoch: Optional[int] = None

    # the ledger's keys of a new best epoch: (val metric, test at best)
    BEST_KEYS = ("new_best_val", "test_at_best")

    def _steps(self, accum_steps: int):
        """(full step, eval step) of the task."""
        return (make_full_step(self.task, accum_steps),
                make_eval_step(self.task))

    # -------------------------------------------------------------- epochs

    def generators(self, epoch: int):
        """(augmentation generator, model generator) of `epoch`."""
        seed = epoch_seed(self.seed, epoch)
        host = torch.Generator().manual_seed(seed)
        if self.device.type == "cuda" and self.task.has_dropout:
            return host, torch.Generator(self.device).manual_seed(seed)
        return host, host

    def _host_augmented(self, batches, seeds):
        """The epoch's batches with their images augmented on the host by
        the C++ loader's pool, one seed a batch: float32, normalized."""
        from ssl4gie_tpu_torch.data import native_loader
        if self._native_aug_pool is None:
            self._native_aug_pool = native_loader.NativeBatchLoader()
        for batch, seed in zip(batches, seeds):
            yield dict(batch, image=native_loader.augment_classification(
                self._native_aug_pool, batch["image"], seed))

    def train_epoch(self, epoch: int):
        meter = Throughput()
        last_loss = None
        batches = self.train_loader.epoch(epoch)
        n_steps = max(len(self.train_loader), 1)
        aug_gen, model_gen = self.generators(epoch)
        key = self.task.target_key
        host_aug = (self.task.aug_mode == "classification"
                    and self.task.aug_fn is None
                    and self.task.mixup_fn is None
                    and os.environ.get("SSL4GIE_HOST_AUG") == "1")
        if host_aug:
            seeds = torch.randint(0, 2**31 - 1, (n_steps,),
                                  generator=aug_gen).tolist()
            batches = self._host_augmented(batches, seeds)
            train_step = make_train_step(self.task, self.accum_steps)
        it = prefetch_to_device(batches, self.device)
        with StepTrace(self.profile_dir if epoch == self.start_epoch
                       else None, self.device,
                       dist_lib.process_index()) as trace:
            for step, batch in enumerate(it):
                if self._stop_requested(step):
                    # mid-epoch preemption: the state as of the last
                    # COMPLETE epoch is what resumes (the per-epoch
                    # generators make the replay deterministic)
                    self._check_preempted(epoch - 1)
                trace.step(step)
                if host_aug:
                    with span("ssl4gie.step"):
                        metrics = train_step(self.model, self.optimizer,
                                             {"image": batch["image"],
                                              key: batch[key]}, model_gen)
                else:
                    metrics = self.full_step(self.model, self.optimizer,
                                             batch["image"], batch[key],
                                             aug_gen, model_gen)
                meter.update(batch["image"].shape[0])
                if ((step + 1) % self.log_every == 0
                        or step + 1 == len(self.train_loader)):
                    last_loss = float(metrics["loss"])
                    if not math.isfinite(last_loss):
                        # NaN abort, as the vendored MAE engine's
                        # (`engine_pretrain.py:52-54`)
                        raise FloatingPointError(
                            f"Loss is {last_loss} at epoch {epoch} step "
                            f"{step + 1}, stopping training")
                    payload = {"epoch": epoch, "step": step + 1,
                               "loss": last_loss,
                               "lr": get_lr(self.optimizer),
                               **meter.rates(n_steps - (step + 1))}
                    if step + 1 == len(self.train_loader):
                        mem = peak_memory_mb(self.device)
                        if mem is not None:
                            payload["max_mem_mb"] = mem
                    self.logger.log(payload)
        return last_loss

    def evaluate(self, loader, epoch: int, split: str) -> float:
        """Evaluate a split with the model in eval mode (BatchNorm on its
        running statistics, no dropout), then back in train mode. Each
        batch counts with EQUAL weight, as the reference's test() loops,
        which average a per-batch metric (`train_segmentation.py:90-95`);
        classification takes meanF1 over all the predictions. Under data
        parallelism each rank evaluates its part of every batch; the
        predictions are gathered in order, or the per-batch sums summed,
        so that every rank gets the single-process number."""
        it = prefetch_to_device(loader.epoch(0), self.device)
        key = self.task.target_key
        split_over = dist_lib.data_group() is not None
        self.model.eval()
        try:
            if self.task.eval_kind == "accumulate_preds":
                preds, targets = [], []
                for batch in it:
                    pred = self.eval_step(
                        self.model, {"image": eval_batch(batch["image"])})
                    if "padding" not in batch:
                        preds.append(pred)
                        targets.append(batch[key])
                    elif split_over:      # an empty part of a batch
                        preds.append(pred[:0])
                        targets.append(batch[key][:0])
                if split_over:
                    preds, targets = self._gather_batches(preds, targets)
                perf = float(self.eval_finalize(torch.cat(preds),
                                                torch.cat(targets)))
            else:
                sums = []
                for batch in it:
                    s = torch.stack(self.eval_step(
                        self.model, {"image": eval_batch(batch["image"]),
                                     key: batch[key]}))
                    sums.append(torch.zeros_like(s) if "padding" in batch
                                else s)
                sums = torch.stack(sums) if sums else None
                if split_over and sums is not None:
                    sums = dist_lib.global_sum(sums)
                total, batches = 0.0, 0
                for num, den in (sums.tolist() if sums is not None else []):
                    total += num / den if den != 0 else 0.0
                    batches += 1
                perf = total / max(batches, 1)
        finally:
            self.model.train()
        self.logger.log({"epoch": epoch, f"{split}_perf": perf})
        return perf

    @staticmethod
    def _gather_batches(preds: list, targets: list):
        """Every data rank's per-batch predictions and targets, batch by
        batch in rank order: the single-process order."""
        mine = [(p.cpu(), t.cpu()) for p, t in zip(preds, targets)]
        ranks = dist_lib.gather_objects(mine)
        preds = [torch.cat([r[b][0] for r in ranks])
                 for b in range(len(mine))]
        targets = [torch.cat([r[b][1] for r in ranks])
                   for b in range(len(mine))]
        return preds, targets

    def _stop_requested(self, step: Optional[int] = None) -> bool:
        """Whether a preemption signal reached any rank, polled at train
        step `step` or at an epoch boundary (`distributed.poll_stop`: over
        several ranks every `log_every` steps)."""
        return self._guard is not None and dist_lib.poll_stop(
            self._guard.should_stop, step, self.log_every)

    # -------------------------------------------------------------- ckpt

    def _ckpt_tree(self, epoch, val_perf, test_perf):
        """A host copy of the whole state and the JAX Trainer's meta (the
        full state on rank 0 of a placed model; every rank calls it)."""
        model_sd, optim_sd = ckpt_lib.state_dicts(self.model, self.optimizer)
        return {"model": model_sd, "optimizer": optim_sd,
                "meta": {"epoch": epoch, "val_perf": val_perf,
                         "test_perf": test_perf,
                         "plateau_best": -1.0 if self.plateau is None or
                         self.plateau.best is None
                         else float(self.plateau.best),
                         "plateau_bad": 0 if self.plateau is None else
                         self.plateau.num_bad_epochs,
                         "lr": get_lr(self.optimizer)}}

    def maybe_resume(self):
        """Resume from the best-val slot, or from the preemption slot when it
        is NEWER (it records a later epoch of the same run); the best-val
        slot keeps serving evaluation either way."""
        src = self.ckpt if self.ckpt.exists() else None
        if self.preempt_ckpt.exists():
            self._preempt_slot_epoch = int(self.preempt_ckpt.meta()["epoch"])
            if (src is None or self._preempt_slot_epoch
                    > int(self.ckpt.meta()["epoch"])):
                src = self.preempt_ckpt
        if src is None:
            return
        restored = src.restore(map_location=self.device)
        ckpt_lib.load_state_dicts(self.model, self.optimizer,
                                  restored["model"], restored["optimizer"])
        meta = restored["meta"]
        self.start_epoch = int(meta["epoch"]) + 1
        self.best_val = float(meta["val_perf"])
        if self.plateau is not None:
            pb = float(meta["plateau_best"])
            self.plateau.best = None if pb < 0 else pb
            self.plateau.num_bad_epochs = int(meta["plateau_bad"])
        self.logger.log({"resumed_from_epoch": self.start_epoch - 1,
                         "best_val": self.best_val})

    # -------------------------------------------------------------- driver

    def fit(self):
        self.maybe_resume()
        try:
            with PreemptionGuard() as self._guard:
                return self._fit()
        except KeyboardInterrupt:
            # clean exit, as the reference's (`train_classification.py:
            # 329-331`); the best-val checkpoint on disk stays valid
            self.logger.log({"interrupted_at_epoch": -1},
                            echo="KeyboardInterrupt — exiting cleanly")
            return self.best_val
        finally:
            self._guard = None

    def _check_preempted(self, epoch: int):
        """Poll the signal latch; if set, save the requeue state and stop.

        The saved meta marks `epoch` epochs COMPLETE and the relaunch starts
        at epoch + 1. A mid-epoch signal saves the snapshot of the last
        epoch BOUNDARY, so the interrupted epoch replays from clean state
        and no batch is applied twice (submitit's requeue from the last
        periodic checkpoint, `submitit_pretrain.py:60-70`)."""
        if not self._stop_requested():
            return
        tree = self._boundary_snapshot
        if tree is None:
            tree = self._ckpt_tree(
                epoch, self.best_val if self.best_val is not None else 0.0,
                0.0)
        ckpt_lib.write(self.preempt_ckpt, tree)
        self._preempt_slot_epoch = int(tree["meta"]["epoch"])
        self.logger.log({"preempted_after_epoch": epoch},
                        echo=f"preemption signal — state saved after epoch "
                             f"{epoch}, exiting for requeue")
        raise Preempted()

    def _fit(self):
        for epoch in range(self.start_epoch, self.epochs + 1):
            # the state with `epoch - 1` epochs complete: what a mid-epoch
            # preemption saves for the requeue
            self._boundary_snapshot = self._ckpt_tree(
                epoch - 1, self.best_val if self.best_val is not None
                else 0.0, 0.0)
            self._check_preempted(epoch - 1)
            self.train_epoch(epoch)
            val_perf = self.evaluate(self.val_loader, epoch, "val")
            test_perf = self.evaluate(self.test_loader, epoch, "test")
            if self.plateau is not None:
                lr = get_lr(self.optimizer)
                new_lr = self.plateau.step(val_perf, lr)
                if new_lr != lr:
                    set_lr(self.optimizer, new_lr)   # every param group
                    self.logger.log({"epoch": epoch, "lr_reduced_to": new_lr})
            better = (self.best_val is None or
                      (val_perf > self.best_val
                       if self.task.select_mode == "max"
                       else val_perf < self.best_val))
            if better:
                self.best_val = val_perf
                ckpt_lib.write(self.ckpt, self._ckpt_tree(epoch, val_perf,
                                                          test_perf))
                best_key, test_key = self.BEST_KEYS
                self.logger.log({"epoch": epoch, best_key: val_perf,
                                 test_key: test_perf})
            # drop a stale .preempt slot once this run has trained past it,
            # so that a later rerun never prefers it to the best-val slot
            if (self._preempt_slot_epoch is not None
                    and epoch > self._preempt_slot_epoch):
                if ckpt_lib.is_primary():
                    self.preempt_ckpt.delete()
                self._preempt_slot_epoch = None
        return self.best_val
