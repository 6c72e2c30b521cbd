"""The port's multi-GPU layer on the CPU: two ranks over gloo.

One 2-rank group, spawned once by the module's fixture (`legs`), runs
every leg and writes its results for the tests. While it runs, this
process computes the references:
- JAX's own GSPMD step on two of the eight virtual CPU devices
  (`tests/conftest.py`), for the ViT classifier legs: data parallelism,
  tensor parallelism (the JAX package's `place_tp` over a (1, 2) mesh)
  and FSDP (`make_place_fn(fsdp=True)`), at the same weights (converted
  by `convert/from_jax.py`) and on the same global batch, two AdamW steps
  with weighted cross-entropy and a global-norm clip;
- the port's single-process run for the other legs, which their own files
  hold to JAX (`test_torch_segmentation.py`, `test_torch_resnet.py`,
  `test_torch_detection_rn50.py`, `test_torch_moco.py`,
  `test_torch_mae.py`): ViT + DPT segmentation with its augmentation and
  dropout, the ResNet-50 classifier under FSDP (BatchNorm's global
  statistics), the RN50-FPN detector at 64 px with its evaluation, MoCo
  v3 vit_s and MAE under tensor parallelism, both through
  `build_pretraining`;
- the Trainer: one epoch's evaluation with a ragged tail (one rank's part
  of the last batch is empty), a fit of two epochs, the same fit resumed
  after one, and a preemption signal sent to rank 1 only, after which
  both ranks exit 42 with one slot written;
- checkpoints: the W = 2 FSDP state loads into one process, and a
  single-process slot loads into the FSDP and the TP ranks and continues
  the run;
- the fused MLP under TP (each rank's hidden units, fc2's bias after the
  sum) against one process's.
A second group of four ranks runs the ViT legs on the (data 2, model 2)
mesh, TP with DDP and TP with FSDP over the data axis (`hybrid`).
The Loader shards, the samplers' global draws and `detect_environment`
are checked in this process, without a group.

Tolerances: the f32 ones of `PERF.md` section 2 (losses 1e-5 relative,
parameters after two AdamW steps 1e-5 with Adam's near-zero-gradient
elements within 2 lr a step); detection 1e-4 / 1e-3; the BatchNorm leg,
whose global statistics sum in another order than one process's means,
1e-4 on its parameters.
"""

import contextlib
import ctypes
import functools
import gc
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2
B, STEPS = 8, 2                     # the ViT legs' global batch and steps
CLASSES, DIM, HEADS, DEPTH, IMG = 4, 64, 4, 2, 32
LR, CLIP = 1e-3, 0.5
CLASS_WEIGHTS = [1.0, 2.0, 0.5, 1.5]
SEG = dict(embed_dim=64, num_heads=2, features=(8, 16, 32, 64),
           fusion_features=16, depth=4, dense_taps=(0, 1, 2, 3))
MOCO_VIT_S = dict(embed_dim=64, depth=1, num_heads=4, stem="patch")
MAE_TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=4)
EPOCHS_UNTIL_SIGNAL = 10 ** 6
TIMEOUT = 900


# ------------------------------------------------------------ the legs
# Each runs in a rank of the group, and in this process as the
# single-process reference.

def _cfg(task="classification", arch="vit_b", out=".", **kw):
    from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                               OptimConfig, RuntimeConfig,
                                               Task, TrainConfig)
    data = dict(batch_size=8, synthetic=True, synthetic_size=9, img_size=IMG,
                num_workers=1)
    data.update(kw.pop("data", {}))
    return TrainConfig(
        task=Task(task), architecture=Architecture(arch),
        epochs=kw.pop("epochs", 1),
        data=DataConfig(**data), optim=OptimConfig(**kw.pop("optim", {})),
        runtime=RuntimeConfig(device="cpu", compute_dtype="float32",
                              **kw.pop("runtime", {})),
        ckpt_dir=out, log_dir=out, **kw)


def _vit_task():
    from ssl4gie_tpu_torch.core.trainer import TaskDefinition
    from ssl4gie_tpu_torch.metrics.classification import \
        weighted_cross_entropy
    return TaskDefinition(
        name="classification", aug_mode="none", target_key="label",
        loss_fn=functools.partial(weighted_cross_entropy,
                                  class_weights=torch.tensor(CLASS_WEIGHTS)))


def _vit_mesh(kind):
    """(mesh, TP, FSDP) of a ViT leg: dp, tp, fsdp (two ranks), hybrid
    and hybrid_fsdp (four ranks: data 2 x model 2)."""
    from ssl4gie_tpu_torch.core.mesh import make_mesh
    from ssl4gie_tpu_torch.parallel.tp import make_tp_mesh
    if kind in ("tp", "hybrid", "hybrid_fsdp"):
        return (make_tp_mesh(2, HEADS, device="cpu"), True,
                kind == "hybrid_fsdp")
    return make_mesh(device="cpu"), False, kind == "fsdp"


def _vit_leg(shared, kind, out, first=0, slot=None, save_after=None):
    """The narrow ViT classifier placed by `kind` (dp, tp, fsdp; single
    without a group), steps `first`..STEPS-1 on this rank's rows of the
    global batches, from `shared`'s weights or the full state in `slot`."""
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    from ssl4gie_tpu_torch.core.train_state import make_adamw
    from ssl4gie_tpu_torch.core.trainer import make_full_step
    from ssl4gie_tpu_torch.core.mesh import shard_batch
    from ssl4gie_tpu_torch.models.vit import ViTClassifier
    from ssl4gie_tpu_torch.parallel.tp import make_place_fn
    mesh, tp, fsdp = _vit_mesh(kind)
    model = ViTClassifier(CLASSES, depth=DEPTH, embed_dim=DIM,
                          num_heads=HEADS, img_size=IMG, device="cpu")
    model.load_state_dict(shared["vit"])
    model = make_place_fn(mesh, tp=tp, fsdp=fsdp)(model)
    opt = make_adamw(model.parameters(), LR, grad_clip=CLIP)
    if slot is not None:
        tree = torch.load(slot, weights_only=True)
        ckpt_lib.load_state_dicts(model, opt, tree["model"], tree["optimizer"])
    step = make_full_step(_vit_task(), 1)
    losses = []
    for s in range(first, STEPS):
        img, label = shard_batch([torch.from_numpy(shared["img"][s]),
                                  torch.from_numpy(shared["label"][s])],
                                 mesh)
        out_ = step(model, opt, img, label, torch.Generator().manual_seed(s))
        losses.append(float(out_["loss"]))
        if save_after == s:
            msd, osd = ckpt_lib.state_dicts(model, opt)
            ckpt_lib.write(ckpt_lib.CheckpointManager(out, f"vit_{kind}"),
                           {"model": msd, "optimizer": osd})
    msd, osd = ckpt_lib.state_dicts(model, opt)
    return {"losses": losses, "model": msd, "optimizer": osd}


def _mixup_leg(shared):
    """Mixup and cutmix of this rank's rows, with 1 and 2 microbatches."""
    from ssl4gie_tpu_torch.data.augment import mixup_cutmix
    from ssl4gie_tpu_torch.parallel.distributed import local_rows
    res = {}
    for accum in (1, 2):
        rows = torch.as_tensor(local_rows(B, accum))
        for cut in (False, True):
            params = {"use_cutmix": cut, "lam": 0.7, "cy": 13, "cx": 20}
            res[accum, cut] = mixup_cutmix(
                torch.from_numpy(shared["mix"])[rows],
                torch.from_numpy(shared["soft"])[rows], params, accum)
    return res


def _fused_mlp_leg(tp: bool):
    """A bf16 MLP block (C 128, H 256) through the fused route
    (`layers.FUSED_MLP`), split over the two ranks' hidden units when
    `tp`: the output and the input's gradient."""
    from torch import nn

    from ssl4gie_tpu_torch.models import layers
    from ssl4gie_tpu_torch.parallel.tp import make_place_fn, make_tp_mesh
    model = nn.Module()
    model.blocks = nn.ModuleList([nn.Module()])
    model.blocks[0].mlp = mlp = layers.Mlp(128, 256, dtype=torch.bfloat16)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    if tp:
        make_place_fn(make_tp_mesh(2, device="cpu"), tp=True)(model)
    x = torch.randn((2, 64, 128), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16).requires_grad_()
    fused, layers.FUSED_MLP = layers.FUSED_MLP, True
    try:
        y = mlp(x)
        y.float().square().sum().backward()
    finally:
        layers.FUSED_MLP = fused
    return {"y": y.detach().float(), "dx": x.grad.float(),
            "hidden": mlp.fc1.weight.shape[0]}


def _first_batch(loader, epoch=1):
    return {k: torch.from_numpy(v) for k, v in next(iter(
        loader.epoch(epoch))).items()}


def _state(trainer):
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    return ckpt_lib.state_dicts(trainer.model)[0]


def _cls_leg(out):
    """The Trainer of a narrow ViT classification run: its evaluation with
    a ragged tail (9 samples in batches of 8), a fit of two epochs, and
    the same fit resumed after one."""
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    narrow = dict(depth=DEPTH, embed_dim=DIM, num_heads=HEADS)
    res = {}
    t = build_trainer(_cfg(out=os.path.join(out, "cls_eval")), **narrow)
    res["eval"] = t.evaluate(t.val_loader, 0, "val")
    t = build_trainer(_cfg(out=os.path.join(out, "cls_a"), epochs=2),
                      **narrow)
    res["best"] = t.fit()
    res["straight"] = _state(t)
    for epochs in (1, 2):
        t = build_trainer(_cfg(out=os.path.join(out, "cls_b"),
                               epochs=epochs), **narrow)
        res[f"best_{epochs}"] = t.fit()
    res["resumed"] = _state(t)
    res["start_epoch"] = t.start_epoch
    return res


def _seg_leg(out):
    """One ViT + DPT segmentation step with the augmentation and the
    head's dropout, then the validation Dice (6 samples, batches of 4)."""
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    t = build_trainer(_cfg("segmentation", out=out, data=dict(
        batch_size=4, synthetic_size=6, img_size=224)), **SEG)
    aug_gen, model_gen = t.generators(1)
    batch = _first_batch(t.train_loader)
    loss = t.full_step(t.model, t.optimizer, batch["image"], batch["mask"],
                       aug_gen, model_gen)["loss"]
    return {"loss": float(loss), "model": _state(t),
            "val": t.evaluate(t.val_loader, 1, "val")}


def _bn_leg(out):
    """Two steps of the ResNet-50 classifier (one block a stage) under
    FSDP: BatchNorm's statistics over the global batch."""
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    t = build_trainer(_cfg("classification", "resnet50", out=out,
                           data=dict(synthetic_size=16),
                           runtime=dict(fsdp=True)),
                      stage_sizes=(1, 1, 1, 1))
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    aug_gen, model_gen = t.generators(1)
    losses, moments = [], None
    for batch in t.train_loader.epoch(1):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        losses.append(float(t.full_step(t.model, t.optimizer, batch["image"],
                                        batch["label"], aug_gen,
                                        model_gen)["loss"]))
        if moments is None:     # Adam's first moment: 0.1 x the gradient
            moments = ckpt_lib.state_dicts(t.model, t.optimizer)[1]
    return {"losses": losses, "model": _state(t), "moments": moments}


def _det_leg(out):
    """One step of the RN50-FPN detector at 64 px (global batch 4) and its
    mAP over 5 frames in batches of 2."""
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    t = build_trainer(_cfg("detection", "resnet50", out=out, data=dict(
        batch_size=4, synthetic_size=5, img_size=64)))
    aug_gen, model_gen = t.generators(1)
    losses = t.full_step(t.model, t.optimizer, _first_batch(t.train_loader),
                         aug_gen, model_gen)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "model": _state(t), "map": t.evaluate(t.val_source, 1, "val")}


@contextlib.contextmanager
def _narrow_presets():
    from ssl4gie_tpu_torch.ssl import moco_v3 as tmoco
    old = tmoco.VIT_PRESETS["vit_s"]
    tmoco.VIT_PRESETS["vit_s"] = MOCO_VIT_S
    try:
        yield
    finally:
        tmoco.VIT_PRESETS["vit_s"] = old


def _pretrain_leg(out, framework, tp=1):
    """Two steps of `build_pretraining`'s run on the first batch (8 of the
    synthetic canvases), then its slots."""
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                               PretrainConfig, RuntimeConfig,
                                               SSLFramework)
    from ssl4gie_tpu_torch.core.trainer import epoch_seed
    from ssl4gie_tpu_torch.ssl.pretrain import build_pretraining
    mae = framework == "mae"
    cfg = PretrainConfig(
        framework=SSLFramework(framework),
        architecture=Architecture("vit_b" if mae else "vit_s"),
        epochs=4, warmup_epochs=0, batch_size=8, img_size=IMG, moco_dim=16,
        moco_mlp_dim=32, model_kwargs=MAE_TINY if mae else {},
        data=DataConfig(synthetic=True, synthetic_size=8, num_workers=1),
        runtime=RuntimeConfig(device="cpu", compute_dtype="float32",
                              tensor_parallel=tp),
        ckpt_dir=out)
    with _narrow_presets():
        run = build_pretraining(cfg)
        img = _first_batch(run.loader)["image"]
        gen = torch.Generator().manual_seed(epoch_seed(cfg.runtime.seed, 1))
        outs = [run.full_step(run.model, run.optimizer, img, gen, s)
                for s in range(2)]
        run.save(1)
    return {"losses": [float(o["loss"]) for o in outs],
            "grad_norms": [float(o["grad_norm"]) for o in outs],
            "model": ckpt_lib.state_dicts(run.model)[0]}


def _preempt_leg(out):
    """A fit that runs until a preemption signal: each rank marks the start
    of its second epoch, then the test signals rank 1."""
    from ssl4gie_tpu_torch.core.preempt import REQUEUE_EXIT_CODE, Preempted
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    rank = torch.distributed.get_rank()
    t = build_trainer(_cfg(out=os.path.join(out, "pre"),
                           epochs=EPOCHS_UNTIL_SIGNAL),
                      depth=1, embed_dim=32, num_heads=2)
    train_epoch = t.train_epoch

    def marked(epoch):
        if epoch == 2:
            open(os.path.join(out, f"ready{rank}"), "w").close()
        return train_epoch(epoch)

    t.train_epoch = marked
    try:
        t.fit()
    except Preempted:
        sys.stdout.flush()
        os._exit(REQUEUE_EXIT_CODE)


def _worker():
    """One rank of the 2-rank group (launched by `legs`) or of the 4-rank
    one (`hybrid`)."""
    out = os.environ["SSL4GIE_TEST_OUT"]
    from ssl4gie_tpu_torch.core.mesh import maybe_init_distributed
    assert maybe_init_distributed("cpu")
    rank = torch.distributed.get_rank()
    shared = torch.load(os.path.join(out, "shared.pt"), weights_only=False)
    if torch.distributed.get_world_size() == 4:
        torch.save({kind: _vit_leg(shared, kind, out) for kind in HYBRID},
                   os.path.join(out, f"rank{rank}.pt"))
        return
    res = {kind: _vit_leg(shared, kind, out, save_after=STEPS - 1
                          if kind == "fsdp" else None)
           for kind in ("dp", "tp", "fsdp")}
    for kind in ("fsdp", "tp"):
        res[f"{kind}_loaded"] = _vit_leg(
            shared, kind, out, first=1,
            slot=os.path.join(out, "vit_single.pt"))
    from ssl4gie_tpu_torch.parallel.distributed import set_data_group
    set_data_group(None)      # the whole world, after the TP placements
    res["mixup"] = _mixup_leg(shared)
    res["fused_mlp"] = _fused_mlp_leg(tp=True)
    res["cls"] = _cls_leg(os.path.join(out, "w2"))
    res["seg"] = _seg_leg(os.path.join(out, "w2", "seg"))
    res["bn"] = _bn_leg(os.path.join(out, "w2", "bn"))
    res["det"] = _det_leg(os.path.join(out, "w2", "det"))
    res["moco"] = _pretrain_leg(os.path.join(out, "w2", "moco"), "mocov3")
    res["mae"] = _pretrain_leg(os.path.join(out, "w2", "mae"), "mae", tp=2)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    _preempt_leg(out)
    os._exit(1)       # the fit returned without the signal


# ------------------------------------------------------------ the group

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(out, entry: str, log: str, **env):
    """This module's `entry` in a process of its own (`out` its directory,
    one thread)."""
    env = dict(os.environ, SSL4GIE_TEST_OUT=out, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([TESTS, REPO]), **env)
    return subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_distributed as t; t.{entry}()"],
        cwd=TESTS, env=env, stdout=open(os.path.join(out, log), "w"),
        stderr=subprocess.STDOUT)


def _launch(out, world=WORLD):
    port = str(_free_port())
    return [_spawn(out, "_worker", f"log{rank}.txt", RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for rank in range(world)]


def _wait(procs, out):
    """Wait for the ranks, sending SIGTERM to rank 1 once ranks 0 and 1
    have started their second epoch of the preemption leg."""
    deadline = time.time() + TIMEOUT
    signalled = False
    while any(p.poll() is None for p in procs):
        if time.time() > deadline:
            for p in procs:
                p.kill()
            break
        if not signalled and all(os.path.exists(os.path.join(
                out, f"ready{r}")) for r in range(WORLD)):
            procs[1].send_signal(signal.SIGTERM)
            signalled = True
        time.sleep(0.05)
    logs = "".join(open(os.path.join(out, f"log{r}.txt")).read()[-4000:]
                   for r in range(len(procs)))
    return [p.returncode for p in procs], signalled, logs


def _jax_weights_and_batches():
    import jax
    import jax.numpy as jnp

    from ssl4gie_tpu.models.vit import ViTClassifier as JaxViT
    from ssl4gie_tpu_torch.convert.from_jax import \
        vit_classifier_params_to_torch
    from ssl4gie_tpu_torch.data.augment import eval_batch
    model = JaxViT(num_classes=CLASSES, img_size=IMG, dtype=jnp.float32,
                   depth=DEPTH, embed_dim=DIM, num_heads=HEADS)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (STEPS, B, IMG, IMG, 3), dtype=np.uint8)
    label = rng.integers(0, CLASSES, (STEPS, B)).astype(np.int64)
    soft = rng.dirichlet(np.ones(CLASSES), B).astype(np.float32)
    return model, params, {
        "vit": vit_classifier_params_to_torch(params), "img": u8,
        "label": label,
        "norm": np.stack([eval_batch(torch.from_numpy(x)).numpy()
                          for x in u8]),
        "mix": rng.normal(size=(B, 24, 24, 3)).astype(np.float32),
        "soft": soft}


def _jax_legs(model, params, shared, kinds=("dp", "tp", "fsdp")):
    """JAX's GSPMD step over two devices (four for the hybrids), for each
    placement: (losses, parameters after STEPS steps) in the port's
    names."""
    import jax
    import jax.numpy as jnp

    from ssl4gie_tpu.core.mesh import data_sharding, make_mesh, replicated
    from ssl4gie_tpu.core.train_state import TrainState, make_adamw
    from ssl4gie_tpu.core.trainer import TaskDefinition, make_train_step
    from ssl4gie_tpu.metrics.classification import weighted_cross_entropy
    from ssl4gie_tpu.parallel.tp import make_place_fn, place_tp
    from ssl4gie_tpu_torch.convert.from_jax import \
        vit_classifier_params_to_torch
    td = TaskDefinition(name="classification", aug_mode="none",
                        target_key="label", eval_metric_fn=None,
                        loss_fn=functools.partial(
                            weighted_cross_entropy,
                            class_weights=jnp.asarray(CLASS_WEIGHTS)))
    out = {}
    for kind in kinds:
        devices = jax.devices()[:4 if kind.startswith("hybrid") else 2]
        if kind.startswith("hybrid"):
            mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
            place = make_place_fn(mesh, tp=True, fsdp=kind == "hybrid_fsdp")
        elif kind == "tp":
            mesh = make_mesh((1, 2), ("data", "model"), devices=devices)
            place = functools.partial(place_tp, mesh=mesh)
        else:
            mesh = make_mesh((2,), devices=devices)
            place = (make_place_fn(mesh, fsdp=True) if kind == "fsdp"
                     else lambda s: jax.device_put(s, replicated(mesh)))
        state = place(TrainState.create(
            model.apply, jax.tree_util.tree_map(jnp.array, params),
            make_adamw(LR, grad_clip=CLIP), {}))
        step = make_train_step(td, 1, top_level=False)
        losses = []
        for s in range(STEPS):
            batch = {"image": jax.device_put(shared["norm"][s],
                                             data_sharding(mesh, 4)),
                     "label": jax.device_put(
                         shared["label"][s].astype(np.int32),
                         data_sharding(mesh, 1))}
            state, m = step(state, batch, jax.random.PRNGKey(s))
            losses.append(float(m["loss"]))
        out[kind] = {"losses": losses, "model": vit_classifier_params_to_torch(
            jax.tree_util.tree_map(np.asarray, state.params))}
    return out


def _reference():
    """The references, in a process of their own, so that the test
    process keeps none of their memory: the shared weights and batches
    (`shared.pt`, then the ranks start), the single-process ViT run and
    its slot after step 1, JAX's GSPMD legs on the eight virtual devices,
    and the single-process port legs (`ref.pt`)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = os.environ["SSL4GIE_TEST_OUT"]
    model, params, shared = _jax_weights_and_batches()
    ref = {"single": _vit_leg(shared, "single", out, save_after=0)}
    torch.save(shared, os.path.join(out, "shared.tmp"))
    os.replace(os.path.join(out, "shared.tmp"), os.path.join(out, "shared.pt"))
    ref["jax"] = _jax_legs(model, params, shared,
                           ("dp", "tp", "fsdp", "hybrid"))
    ref["mixup"] = _mixup_leg(shared)
    ref["fused_mlp"] = _fused_mlp_leg(tp=False)
    w1 = os.path.join(out, "w1")
    ref["cls"] = _cls_leg(w1)
    ref["seg"] = _seg_leg(os.path.join(w1, "seg"))
    ref["bn"] = _bn_leg(os.path.join(w1, "bn"))
    ref["det"] = _det_leg(os.path.join(w1, "det"))
    ref["moco"] = _pretrain_leg(os.path.join(w1, "moco"), "mocov3")
    ref["mae"] = _pretrain_leg(os.path.join(w1, "mae"), "mae")
    torch.save(ref, os.path.join(out, "ref.pt"))


def _log(out, name):
    return open(os.path.join(out, name)).read()[-4000:]


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The reference process, then, once it has written the shared
    weights and batches, the 2-rank group; every rank's results and the
    references: {"ranks": [rank 0's, rank 1's], "ref": ..., "out": ...}."""
    out = str(tmp_path_factory.mktemp("dist"))
    ref_proc = _spawn(out, "_reference", "log_ref.txt", JAX_PLATFORMS="cpu",
                      XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    try:
        deadline = time.time() + TIMEOUT
        while not os.path.exists(os.path.join(out, "shared.pt")):
            assert ref_proc.poll() is None and time.time() < deadline, \
                _log(out, "log_ref.txt")
            time.sleep(0.05)
        procs = _launch(out)
        rcs, signalled, logs = _wait(procs, out)
        assert signalled and rcs == [42, 42], (rcs, logs)
        assert ref_proc.wait(timeout=TIMEOUT) == 0, _log(out, "log_ref.txt")
    finally:
        for p in [ref_proc, *procs]:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    res = {"ranks": ranks, "out": out,
           "ref": torch.load(os.path.join(out, "ref.pt"), weights_only=False)}
    yield res
    # hand the results' memory back: this process runs other test files
    res.clear()
    gc.collect()
    ctypes.CDLL(None).malloc_trim(0)


HYBRID = ("hybrid", "hybrid_fsdp")


@pytest.fixture(scope="module")
def hybrid(legs, tmp_path_factory):
    """A 4-rank group on the same weights and batches: the ViT legs on the
    (data 2, model 2) mesh, TP with DDP and TP with FSDP over the data
    axis. Returns (JAX's hybrid legs, the ranks' results)."""
    out = str(tmp_path_factory.mktemp("hybrid"))
    os.symlink(os.path.join(legs["out"], "shared.pt"),
               os.path.join(out, "shared.pt"))
    rcs, _, logs = _wait(_launch(out, 4), out)
    assert rcs == [0] * 4, (rcs, logs)
    return legs["ref"]["jax"], [torch.load(os.path.join(out, f"rank{r}.pt"),
                                           weights_only=False)
                                for r in range(4)]


# ------------------------------------------------------------ assertions

def _assert_params_close(got: dict, want: dict, steps: int = STEPS,
                         tol: float = 1e-5):
    """Every tensor of `want` in `got`; all within 2 lr a step (Adam's
    sign on a gradient within rounding of zero) and 99.9% within `tol`."""
    assert set(got) >= set(want), set(want) - set(got)
    diffs = np.concatenate([np.abs(np.asarray(got[k], np.float64)
                                   - np.asarray(want[k], np.float64)).ravel()
                            for k in want])
    assert diffs.max() <= 2 * LR * steps * (1 + 1e-3), diffs.max()
    assert np.mean(diffs <= tol) >= 0.999


@pytest.mark.parametrize("kind", ["dp", "tp", "fsdp"])
def test_vit_legs_match_jax_gspmd(legs, kind):
    """DP, TP and FSDP over two ranks: each rank's logged loss is the
    global batch's, as JAX's GSPMD step on two devices gives it, and the
    parameters after two AdamW steps (weighted cross-entropy, global-norm
    clip) are JAX's."""
    want = legs["ref"]["jax"][kind]
    for rank in legs["ranks"]:
        np.testing.assert_allclose(rank[kind]["losses"], want["losses"],
                                   rtol=1e-5)
    _assert_params_close(legs["ranks"][0][kind]["model"], want["model"])


@pytest.mark.parametrize("kind", HYBRID)
def test_hybrid_legs_match_jax_gspmd(hybrid, kind):
    """Four ranks, data 2 x model 2: TP with DDP, and TP with FSDP, over
    the data axis give JAX's hybrid GSPMD step, TP over "model" and the
    parameters replicated over "data" (loss on every rank, the parameters
    after two AdamW steps). JAX's TP x FSDP placement itself is not the
    reference here: on the virtual CPU mesh its first loss is 0.35% off
    its own DP step's (ROADMAP queue 3); the placement changes no math,
    and the port's agrees with the DP step."""
    ref, ranks = hybrid
    for rank in ranks:
        np.testing.assert_allclose(rank[kind]["losses"],
                                   ref["hybrid"]["losses"], rtol=1e-5)
    _assert_params_close(ranks[0][kind]["model"], ref["hybrid"]["model"])


def test_single_process_matches_jax(legs):
    """The port's one-process run of the same steps is JAX's too."""
    want = legs["ref"]["jax"]["dp"]
    np.testing.assert_allclose(legs["ref"]["single"]["losses"],
                               want["losses"], rtol=1e-5)
    _assert_params_close(legs["ref"]["single"]["model"], want["model"])


@pytest.mark.parametrize("kind", ["dp", "tp", "fsdp"])
def test_vit_legs_optimizer_state_is_single_process(legs, kind):
    """The gathered optimizer state has one process's format and values:
    the same numbered parameters and groups, Adam's moments within 1e-6
    of the single-process run's."""
    got = legs["ranks"][0][kind]["optimizer"]
    want = legs["ref"]["single"]["optimizer"]
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(got["state"][i][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6, err_msg=(i, k))


def test_fsdp_save_loads_in_one_process(legs):
    """The W = 2 FSDP slot holds the full state under one process's names:
    it loads into a plain model and optimizer, bitwise what rank 0
    gathered."""
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    from ssl4gie_tpu_torch.core.train_state import make_adamw
    from ssl4gie_tpu_torch.models.vit import ViTClassifier
    tree = torch.load(os.path.join(legs["out"], "vit_fsdp.pt"),
                      weights_only=True)
    model = ViTClassifier(CLASSES, depth=DEPTH, embed_dim=DIM,
                          num_heads=HEADS, img_size=IMG, device="cpu")
    opt = make_adamw(model.parameters(), LR, grad_clip=CLIP)
    ckpt_lib.load_state_dicts(model, opt, tree["model"], tree["optimizer"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, legs["ranks"][0]["fsdp"]["model"][k]), k
    assert opt.state_dict()["param_groups"] == \
        legs["ranks"][0]["fsdp"]["optimizer"]["param_groups"]


@pytest.mark.parametrize("kind", ["fsdp", "tp"])
def test_single_process_slot_resumes_placed(legs, kind):
    """A slot saved by one process after step 1 loads into the two FSDP
    or TP ranks (model and optimizer: sharded over the data ranks, or cut
    to each rank's heads), whose step 2 is the single process's."""
    got = legs["ranks"][0][f"{kind}_loaded"]
    want = legs["ref"]["single"]
    for rank in legs["ranks"]:
        np.testing.assert_allclose(rank[f"{kind}_loaded"]["losses"],
                                   want["losses"][1:], rtol=1e-5)
    _assert_params_close(got["model"], want["model"], steps=1)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("cut", [False, True])
def test_mixup_partner_is_global(legs, accum, cut):
    """Mixup and cutmix of each rank's rows take their reverse-order
    partners from the global batch: together the rows are the
    single-process result, with one microbatch and with two."""
    from ssl4gie_tpu_torch.parallel.distributed import local_rows
    want_img, want_t = legs["ref"]["mixup"][accum, cut]
    for r, rank in enumerate(legs["ranks"]):
        rows = local_rows(B, accum, (r, WORLD))
        img, t = rank["mixup"][accum, cut]
        assert torch.equal(img, want_img[rows])
        assert torch.equal(t, want_t[rows])


def test_fused_mlp_under_tp(legs):
    """The fused MLP under TP: each rank runs it on its 128 of the 256
    hidden units with a zero fc2 bias, and fc2's bias is added once after
    the sum; the output and the input's gradient are one process's, to
    bf16 rounding (2^-6 of the largest)."""
    want = legs["ref"]["fused_mlp"]
    for rank in legs["ranks"]:
        got = rank["fused_mlp"]
        assert got["hidden"] == want["hidden"] // 2
        for k in ("y", "dx"):
            err = (got[k] - want[k]).abs().max().item()
            assert err <= 2 ** -6 * want[k].abs().max().item(), (k, err)


def test_eval_gathers_a_ragged_tail(legs):
    """meanF1 over 9 validation samples in batches of 8, the last batch's
    one sample on rank 0 and nothing on rank 1: every rank gets the
    single-process value."""
    for rank in legs["ranks"]:
        assert rank["cls"]["eval"] == pytest.approx(
            legs["ref"]["cls"]["eval"], rel=1e-6)


def test_trainer_fit_matches_one_process(legs):
    """Two epochs of `Trainer.fit` (steps, evaluation, plateau, best-val
    slot) at W = 2: the best validation value and the parameters of one
    process."""
    want = legs["ref"]["cls"]
    for rank in legs["ranks"]:
        assert rank["cls"]["best"] == pytest.approx(want["best"], rel=1e-6)
    got = legs["ranks"][0]["cls"]["straight"]
    for k, v in want["straight"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_resume_at_two_ranks_is_bitwise(legs):
    """The fit stopped after epoch 1 and resumed from its slot for epoch 2
    (both at W = 2) ends bitwise where the straight fit ends."""
    got = legs["ranks"][0]["cls"]
    assert got["start_epoch"] == 2
    for k, v in got["straight"].items():
        assert torch.equal(got["resumed"][k], v), k


def test_preemption_of_one_rank_stops_both(legs):
    """SIGTERM to rank 1 only: both ranks exit 42 at the same step (the
    fixture asserts the codes), and rank 0 wrote the one requeue slot."""
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    d = os.path.join(legs["out"], "pre")
    slots = [f for f in os.listdir(d) if f.endswith(".preempt.pt")]
    assert len(slots) == 1
    meta = ckpt_lib.CheckpointManager(d, slots[0][:-3]).meta()
    assert 1 <= meta["epoch"] < EPOCHS_UNTIL_SIGNAL


def test_segmentation_leg_matches_one_process(legs):
    """ViT + DPT segmentation: the augmentation's and the dropout's draws
    for the global batch, the Dice loss, the step, and the validation
    Dice with batches split over ranks."""
    want = legs["ref"]["seg"]
    for rank in legs["ranks"]:
        assert rank["seg"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert rank["seg"]["val"] == pytest.approx(want["val"], rel=1e-5)
    _assert_params_close(legs["ranks"][0]["seg"]["model"],
                         {k: v for k, v in want["model"].items()}, steps=1,
                         tol=1e-6)


def test_batchnorm_leg_matches_one_process(legs):
    """ResNet-50 under FSDP: BatchNorm's statistics over the global batch.
    The first step's loss and gradients (Adam's first moment) are one
    process's, to the order in which the ranks sum; so are the parameters
    and running statistics after two AdamW steps, to Adam's elements of
    near-zero gradient (2 lr a step, as in `PERF.md` section 2), and the
    second step's loss to 1e-4."""
    want = legs["ref"]["bn"]
    for rank in legs["ranks"]:
        np.testing.assert_allclose(rank["bn"]["losses"][0],
                                   want["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(rank["bn"]["losses"][1],
                                   want["losses"][1], rtol=1e-4)
    got = legs["ranks"][0]["bn"]
    for i, st in want["moments"]["state"].items():
        g, w = got["moments"]["state"][i]["exp_avg"], st["exp_avg"]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-9,
                                   err_msg=str(i))
    assert set(got["model"]) == set(want["model"])
    diffs = np.concatenate([(got["model"][k] - v).abs().numpy().ravel()
                            for k, v in want["model"].items()])
    assert diffs.max() <= 2 * 1e-4 * 2 * (1 + 1e-3)     # the run's lr 1e-4
    assert np.mean(diffs <= 1e-5) >= 0.99


def test_detection_leg_matches_one_process(legs):
    """The RN50-FPN detector at 64 px: the four losses (the RoI heads'
    normalizer over the global batch's samples), the step, and the mAP of
    the frames split over ranks."""
    want = legs["ref"]["det"]
    for rank in legs["ranks"]:
        for k, v in want["losses"].items():
            assert rank["det"]["losses"][k] == pytest.approx(v, rel=1e-4), k
        assert rank["det"]["map"] == pytest.approx(want["map"], abs=1e-6)
    got = legs["ranks"][0]["det"]["model"]
    for k, v in want["model"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("leg", ["moco", "mae"])
def test_pretraining_legs_match_one_process(legs, leg):
    """MoCo v3 vit_s over DDP (keys gathered from both ranks, the heads'
    BatchNorm global) and MAE under tensor parallelism (encoder and
    decoder heads split 2 ways): two steps' losses and gradient norms,
    and the parameters, of one process."""
    want = legs["ref"][leg]
    for rank in legs["ranks"]:
        np.testing.assert_allclose(rank[leg]["losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank[leg]["grad_norms"],
                                   want["grad_norms"], rtol=1e-4)
    got = legs["ranks"][0][leg]["model"]
    assert set(got) == set(want["model"])
    for k, v in want["model"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------ no group

@pytest.mark.parametrize("accum", [1, 2])
def test_loader_shards_union_is_the_batch(accum):
    """Each rank reads only its rows of every batch from the shared
    permutation; together, in order, they are the single-process batches
    (training with 1 and 2 microbatches; evaluation with a ragged tail
    of 1, whose empty part on rank 1 comes as one padding row)."""
    from ssl4gie_tpu_torch.data.loader import Loader, SyntheticSource
    from ssl4gie_tpu_torch.parallel.distributed import local_rows
    src = SyntheticSource(17, 8, seed=3)
    for shuffle, drop_last in ((True, True), (False, False)):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5,
                  num_threads=1, accum_steps=accum)
        single = list(Loader(src, 8, **kw).epoch(2))
        shards = [list(Loader(src, 8, shard=(r, WORLD), **kw).epoch(2))
                  for r in range(WORLD)]
        for b, want in enumerate(single):
            parts = [s[b] for s in shards]
            if drop_last:
                got = np.empty_like(want["label"])
                for r, part in enumerate(parts):
                    got[local_rows(8, accum, (r, WORLD))] = part["label"]
            else:
                got = np.concatenate([p["label"] for p in parts
                                      if "padding" not in p])
            np.testing.assert_array_equal(got, want["label"])
            assert ("padding" in parts[1]) == (len(want["label"]) == 1)


def _samplers():
    from ssl4gie_tpu_torch.data import augment as aug
    from ssl4gie_tpu_torch.data import randaug, ssl_augment
    from ssl4gie_tpu_torch.tasks.detection import sample_detection_params
    return {
        "classification": (aug.sample_classification_params, ()),
        "segmentation": (aug.sample_segmentation_params, (32,)),
        "depth": (aug.sample_depth_params, ()),
        "detection": (sample_detection_params, ()),
        "mae": (ssl_augment.sample_mae_params, ()),
        "moco": (ssl_augment.sample_moco_params, ()),
        "timm": (randaug.sample_timm_params, (48,)),
    }


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("name", ["classification", "segmentation", "depth",
                                  "detection", "mae", "moco", "timm"])
@pytest.mark.parametrize("accum", [1, 2])
def test_draws_are_the_global_batch_rows(monkeypatch, name, accum):
    """Every sampler drawn for the global batch on each rank (the same
    generator state) gives, at that rank's rows, the single-process draws:
    W ranks augment bitwise as one process does."""
    from ssl4gie_tpu_torch.parallel import distributed as dist_lib
    sample, args = _samplers()[name]
    b = 4
    single = sample(b * WORLD, *args, torch.Generator().manual_seed(9))
    for r in range(WORLD):
        monkeypatch.setattr(dist_lib, "data_shard", lambda r=r: (r, WORLD))
        got = dist_lib.draw_global(sample, b, *args,
                                   torch.Generator().manual_seed(9),
                                   accum_steps=accum)
        want = dist_lib.take_rows(single, dist_lib.local_rows(
            b * WORLD, accum, (r, WORLD)), b * WORLD)
        for g, w in zip(_flat(got), _flat(want), strict=True):
            if torch.is_tensor(w):
                assert torch.equal(g, w)
            else:
                assert g == w


def test_rand_global_is_the_global_draw(monkeypatch):
    """Dropout masks, stochastic depth and MAE's noise: each rank's draw
    is its rows of the global batch's."""
    from ssl4gie_tpu_torch.parallel import distributed as dist_lib
    full = torch.rand((8, 3, 5), generator=torch.Generator().manual_seed(1))
    for r in range(WORLD):
        monkeypatch.setattr(dist_lib, "data_shard", lambda r=r: (r, WORLD))
        got = dist_lib.rand_global((4, 3, 5),
                                   torch.Generator().manual_seed(1))
        assert torch.equal(got, full[4 * r:4 * r + 4])


ENVS = {
    "none": ({}, None),
    "torchrun": ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                  "SLURM_NTASKS": "8", "SLURM_PROCID": "5"},
                 dict(rank=3, world_size=4, local_rank=1)),
    "slurm": ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5",
               "SLURM_LOCALID": "1", "OMPI_COMM_WORLD_SIZE": "2",
               "OMPI_COMM_WORLD_RANK": "1"},
              dict(rank=5, world_size=8, local_rank=1)),
    "slurm-one-task": ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, None),
    "ompi": ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
              "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
             dict(rank=1, world_size=2, local_rank=1)),
    "torchrun-one": ({"RANK": "0", "WORLD_SIZE": "1"}, None),
}


@pytest.mark.parametrize("case", list(ENVS))
def test_detect_environment_precedence(monkeypatch, case):
    """env:// (torchrun) first, then SLURM with more than one task, then
    OpenMPI with more than one process; None for a single process."""
    from ssl4gie_tpu_torch.parallel.distributed import detect_environment
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    env, want = ENVS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert detect_environment() == want


def test_tp_layout_round_trips_and_keeps_heads_together():
    """Each model rank's part of the packed qkv weight is its heads' rows
    of q, of k and of v; the parts join back to the full tensor."""
    from ssl4gie_tpu_torch.parallel.tp import (shard_tensor, tp_spec,
                                               unshard_tensor)
    D, H, tp = 8, 4, 2
    w = torch.arange(3 * D * D, dtype=torch.float32).reshape(3 * D, D)
    spec = tp_spec("backbone.blocks.3.attn.qkv.weight")
    parts = [shard_tensor(w, spec, r, tp) for r in range(tp)]
    dh = D // H
    for r, p in enumerate(parts):
        rows = [w[j * D + r * D // tp: j * D + (r + 1) * D // tp]
                for j in range(3)]
        assert torch.equal(p, torch.cat(rows))
        assert p.shape == (3 * H // tp * dh, D)
    assert torch.equal(unshard_tensor(parts, spec), w)
    assert tp_spec("decoder_blocks.0.mlp.fc2.weight").dim == 1
    assert tp_spec("decoder_blocks.0.mlp.fc2.bias") is None
    assert tp_spec("lin_head.weight") is None


REFUSALS = {
    "detection-tp": (["--task", "detection", "--tp", "2"], None),
    "detection-fsdp": (["--task", "detection", "--fsdp"], None),
    "resnet50-tp": (["--task", "segmentation", "--arch", "resnet50", "--tp",
                     "2"], None),
    "tp-and-mesh-shape": (["--task", "classification", "--tp", "2"], (1, 1)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case):
    """The JAX package's refusals, with its messages: TP or FSDP with
    detection, TP with resnet50, TP with an explicit mesh shape."""
    import argparse

    from ssl4gie_tpu.cli import args as jargs
    from ssl4gie_tpu.tasks.build import build_trainer as jax_build
    from ssl4gie_tpu_torch.cli import args as targs
    from ssl4gie_tpu_torch.tasks.build import build_trainer
    argv, mesh_shape = REFUSALS[case]
    cfgs = []
    for pkg in (jargs, targs):
        p = argparse.ArgumentParser()
        pkg.add_common(p)
        pkg.add_train(p)
        cfg = pkg.to_train_config(p.parse_args(argv + ["--synthetic"]))
        cfg.runtime.mesh_shape = mesh_shape
        cfgs.append(cfg)
    with pytest.raises(ValueError) as want:
        jax_build(cfgs[0])
    with pytest.raises(ValueError) as got:
        build_trainer(cfgs[1])
    assert str(got.value) == str(want.value)


def test_pretrain_tp_refuses_resnet50_as_jax():
    """MoCo v3 resnet50 with --tensor-parallel: the JAX package's
    refusal and message."""
    from ssl4gie_tpu.core import config as jconfig
    from ssl4gie_tpu.ssl.pretrain import run_pretraining
    from ssl4gie_tpu_torch.core import config as tconfig
    from ssl4gie_tpu_torch.ssl.pretrain import build_pretraining
    cfgs = [pkg.PretrainConfig(
        framework=pkg.SSLFramework.MOCOV3,
        architecture=pkg.Architecture.RESNET50,
        runtime=pkg.RuntimeConfig(tensor_parallel=2))
        for pkg in (jconfig, tconfig)]
    cfgs[1].runtime.device = "cpu"
    with pytest.raises(ValueError) as want:
        run_pretraining(cfgs[0])
    with pytest.raises(ValueError) as got:
        build_pretraining(cfgs[1])
    assert str(got.value) == str(want.value)
