"""The port's spans (`core/spans.py`) on the CPU: the layers of each step
entry under `torch.profiler`, the null context without it, and the trace
that `RuntimeConfig.profile_dir` asks of `Trainer` and `run_loop`.

    python -m pytest tests/test_torch_spans.py -q
"""

import glob
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssl4gie_tpu_torch.core import spans
from ssl4gie_tpu_torch.core.checkpoint import CheckpointManager
from ssl4gie_tpu_torch.core.config import (DataConfig, PretrainConfig,
                                           RuntimeConfig, SSLFramework)
from ssl4gie_tpu_torch.core.logger import MetricsLogger
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import (TaskDefinition, Trainer,
                                            make_full_step)
from ssl4gie_tpu_torch.data.loader import Loader, SyntheticSource
from ssl4gie_tpu_torch.ssl import pretrain
from ssl4gie_tpu_torch.ssl.mae import MAE
from ssl4gie_tpu_torch.ssl.moco_v3 import MoCo

torch.set_num_threads(1)

TINY_MAE = dict(patch_size=16, embed_dim=32, depth=1, num_heads=2,
                decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
CHILDREN = ["augment", "forward", "backward", "optimizer"]


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 6)

    def forward(self, x, generator=None):
        return self.lin(x.mean(dim=(1, 2)))


def classification_task():
    return TaskDefinition(
        name="classification", aug_mode="classification", target_key="label",
        loss_fn=lambda out, y: torch.nn.functional.cross_entropy(
            out, y.long()))


def spans_of(path) -> list:
    """(start, end, layer) of each `ssl4gie.` range in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("ssl4gie."):])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("ssl4gie."))


def traced(tmp_path, fn) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return spans_of(path)


def layers_in_order(found: list) -> list:
    """The layers inside the one `step`, by start, repeats run together."""
    steps = [s for s in found if s[2] == "step"]
    assert len(steps) == 1
    t0, t1, _ = steps[0]
    inside = [s for s in found if s[2] != "step"]
    assert all(t0 <= a and b <= t1 for a, b, _ in inside)
    order = []
    for _, _, name in inside:
        if not order or order[-1] != name:
            order.append(name)
    return order


def _mae_step():
    model = MAE(img_size=32, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0), **TINY_MAE)
    optimizer = pretrain.make_mae_optimizer(model, PretrainConfig())
    step = pretrain.make_mae_full_step(lambda s: 1e-3, img_size=32)
    img = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8)
    gen = torch.Generator().manual_seed(1)
    return lambda: step(model, optimizer, img, gen, 0)


def _moco_step():
    moco = MoCo("resnet50", 16, 32, stage_sizes=(1, 1, 1, 1), device="cpu")
    optimizer = make_adamw(moco.trained_parameters(), 1e-3)
    step = pretrain.make_moco_full_step(10, schedule=lambda s: 1e-3,
                                        img_size=32)
    img = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8)
    gen = torch.Generator().manual_seed(1)
    return lambda: step(moco, optimizer, img, gen, 0)


def _classification_step(accum_steps=1):
    net = Net()
    optimizer = make_adamw(net.parameters(), 1e-3)
    step = make_full_step(classification_task(), accum_steps)
    img = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    label = torch.tensor([0, 1, 2, 3])
    gen = torch.Generator().manual_seed(1)
    return lambda: step(net, optimizer, img, label, gen)


@pytest.mark.parametrize("make,order", [
    (_mae_step, CHILDREN),
    (_classification_step, CHILDREN),
    # microbatches: forward and backward once each, then the reduction
    (lambda: _classification_step(2),
     ["augment", "forward", "backward", "forward", "backward", "optimizer"]),
    # MoCo's momentum encoder moves first, as a second optimizer instance
    (_moco_step, ["augment", "optimizer", "forward", "backward",
                  "optimizer"]),
], ids=["mae", "classification", "classification_accum2", "moco"])
def test_a_full_step_is_one_step_span_holding_its_layers(tmp_path, make,
                                                         order):
    assert layers_in_order(traced(tmp_path, make())) == order


def _detection_step():
    from ssl4gie_tpu_torch.models.faster_rcnn import MAX_GT, build_detector
    from ssl4gie_tpu_torch.tasks.detection import make_detection_full_step
    model = build_detector("vit_b", img_size=256, embed_dim=32, depth=1,
                           num_heads=2, rpn_pre_nms_top_n_train=50,
                           rpn_post_nms_top_n_train=20,
                           box_batch_size_per_image=16, device="cpu")
    optimizer = make_adamw(model.parameters(), 1e-3)
    step = make_detection_full_step(accum_steps=2)
    boxes = torch.zeros((2, MAX_GT, 4))
    boxes[:, 0] = torch.tensor([20.0, 30.0, 120.0, 150.0])
    valid = torch.zeros((2, MAX_GT), dtype=torch.bool)
    valid[:, 0] = True
    batch = {"image": torch.randint(0, 256, (2, 256, 256, 3),
                                    dtype=torch.uint8),
             "gt_boxes": boxes, "gt_labels": valid.long(), "gt_valid": valid}
    gen = torch.Generator().manual_seed(1)
    return lambda: step(model, optimizer, batch, gen)


def test_the_detection_step_is_one_step_span_holding_its_layers(tmp_path):
    """Two microbatches: forward and backward twice, then the division of
    the accumulated gradients and the update; the NMS inside each
    forward."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _detection_step()()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    found = spans_of(path)
    assert layers_in_order(found) == ["augment", "forward", "backward",
                                      "forward", "backward", "optimizer"]
    with open(path) as f:
        nms = [(e["ts"], e["ts"] + e["dur"])
               for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("name") == "nms_topk"]
    forwards = [(a, b) for a, b, name in found if name == "forward"]
    assert len(nms) == 2
    assert all(any(a <= s and e <= b for a, b in forwards) for s, e in nms)


def test_without_a_profiler_a_span_is_the_shared_null_context():
    assert spans.span("ssl4gie.step") is spans.span("ssl4gie.forward")
    with spans.span("ssl4gie.step") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("x"), torch.profiler.record_function)
    assert spans.span("x") is spans._NULL


def test_nms_topk_keeps_its_range(tmp_path):
    from ssl4gie_tpu_torch.ops.nms import nms_topk
    boxes = torch.tensor([[[0., 0., 10., 10.], [1., 1., 11., 11.],
                           [20., 20., 30., 30.]]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx, ok = nms_topk(boxes, scores, 0.5, 2)
    assert idx.tolist() == [[0, 2]] and ok.all()
    assert [e.count for e in prof.key_averages() if e.key == "nms_topk"] \
        == [1]


def _trace_steps(directory) -> list:
    """Each trace file in `directory`: the steps it holds."""
    return [len([s for s in spans_of(p) if s[2] == "step"])
            for p in glob.glob(str(directory / "*.pt.trace.json"))]


def test_trainer_profile_dir_traces_steps_5_to_10(tmp_path):
    net = Net()
    loader = Loader(SyntheticSource(16, 32, "classification"), 1, seed=1,
                    num_threads=1)
    trainer = Trainer(task=classification_task(), model=net,
                      optimizer=make_adamw(net.parameters(), 1e-3),
                      device="cpu", train_loader=loader, val_loader=None,
                      test_loader=None,
                      logger=MetricsLogger(str(tmp_path), "run"),
                      ckpt=CheckpointManager(str(tmp_path), "run"),
                      epochs=1, seed=5, log_every=4,
                      profile_dir=str(tmp_path / "trace"))
    trainer.train_epoch(2)              # not the first epoch: no trace
    assert not (tmp_path / "trace").exists()
    trainer.train_epoch(1)
    assert _trace_steps(tmp_path / "trace") == [
        spans.LAST - spans.FIRST + 1]


def test_pretrain_profile_dir_traces_the_first_epoch(tmp_path):
    """An epoch of 7 steps ends the trace after step 6, its last."""
    cfg = PretrainConfig(
        framework=SSLFramework.MAE, epochs=2, warmup_epochs=1, batch_size=1,
        img_size=32, model_kwargs=TINY_MAE, ckpt_dir=str(tmp_path),
        data=DataConfig(synthetic=True, synthetic_size=7, num_workers=1),
        runtime=RuntimeConfig(device="cpu", compute_dtype="float32",
                              log_every=100,
                              profile_dir=str(tmp_path / "trace")))
    pretrain.run_loop(pretrain.build_pretraining(cfg))
    assert _trace_steps(tmp_path / "trace") == [7 - spans.FIRST]
