"""The port's ViTDet-B Faster R-CNN train step against the benchmark's plain
float32 reference (`portbench/configs/vitdet_det1024_ref.py`) on the CPU,
at a small size that keeps every kind of layer: a 512 px canvas (a 32 x 32
token grid, so 2 x 2 windows of 16 x 16), depth 3 with block 2 global,
width 64, the pyramid, the RPN and the box head at their published widths
and fewer proposals. Same seeded weights, batch, ground truth, augmentation
draws and sampler noise; the port in float32.

    python -m pytest tests/test_torch_vitdet_reference.py -q
"""

import json
import statistics

import pytest
import torch

from portbench import harness, inputs, nms_work
from portbench.configs import vitdet_det1024 as program
from portbench.configs import vitdet_det1024_ref as reference
from portbench.reference import detection, plain
from ssl4gie_tpu_torch.tasks.detection import make_detection_full_step

SEED = 2 ** 31 + 12345
SMALL = dict(img_size=512, embed_dim=64, depth=3, num_heads=2, mlp_dim=256,
             rpn_pre_nms_top_n_train=300, rpn_post_nms_top_n_train=100,
             box_batch_size_per_image=64)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(path: str) -> dict:
    with open(harness.BENCH_DIR / path) as f:
        return json.load(f)


def small_cell():
    cfg = dict(load("configs/vitdet_det1024.json"), **SMALL)
    # two microbatches of one image: the accumulated step
    traffic = dict(load("workloads/vitdet_det1024.b48_mb16.json"), batch=2,
                   microbatch=1, canvas=512, pool=1)
    return cfg, traffic


def port_step(cfg, traffic, data, weights, batch, microbatches):
    """One step of the port in float32 at rate 0 (the averaged gradients
    stay in .grad, the weights where they were): its losses and each
    leaf's gradient."""
    prog = program.build(dict(cfg, compute_dtype="float32"), traffic, data,
                         weights, SEED, "cpu")
    assert len(list(prog.model.parameters())) == len(weights)
    for group in prog.optimizer.param_groups:
        group["lr"] = 0.0
    step = make_detection_full_step(microbatches)
    got = step(prog.model, prog.optimizer, batch,
               inputs.generator(SEED, inputs.STEP, "cpu"),
               inputs.generator(SEED, detection.MODEL_NOISE, "cpu"))
    return got, {n: p.grad for n, p in prog.model.named_parameters()}


@pytest.fixture(scope="module")
def steps():
    """The port's accumulated step (two microbatches of one image) and the
    reference's on the same weights, batch, draws and noise."""
    cfg, traffic = small_cell()
    data = inputs.make_traffic(traffic, None, SEED, "cpu")
    weights = inputs.make_weights(program.weight_specs(cfg), cfg["init_std"],
                                  SEED, "cpu")
    batch = data["batches"][0]
    got, grads = port_step(cfg, traffic, data, weights, batch,
                           program.microbatches(traffic))
    img = batch["image"]
    want, ref_grads = reference.step_grads(
        cfg, traffic, {n: w.clone() for n, w in weights.items()}, img,
        detection.draw_gt(traffic, SEED, "cpu")[0],
        detection.draw_augment(img.shape[0],
                               inputs.generator(SEED, inputs.STEP, "cpu")),
        inputs.generator(SEED, detection.MODEL_NOISE, "cpu"),
        detection.anchors(cfg["img_size"], "cpu"), "float32")
    return dict(cfg=cfg, traffic=traffic, data=data, weights=weights,
                batch=batch, got=got, grads=grads, want=want,
                ref_grads=ref_grads)


def test_port_train_step_matches_the_plain_reference(steps):
    got, grads = steps["got"], steps["grads"]
    want, ref_grads = steps["want"], steps["ref_grads"]

    # the losses are continuous in the weights and the inputs: the two
    # sides differ by float32 rounding of differently ordered sums
    # (convolutions as cuDNN/oneDNN calls or as products over unfolded
    # patches, RoIAlign's gather), a few ulps of each loss
    assert set(want) == set(got)
    for key, value in want.items():
        assert abs(float(got[key]) - value) <= 2e-5 * abs(value) + 1e-7, key

    # each leaf's gradient, over the larger of its norm and the median
    # leaf's (as `harness.gaps` measures it). Rounding alone moves most
    # leaves by 1e-6; the proposals move by 1e-4 px of rounding, and where
    # that carries a pre-activation of fc6 or fc7 across ReLU's kink, the
    # gradient of one RoI's unit jumps: a leaf fed by that RoI moves by
    # about 1 / 64 of a RoI's share (measured 4e-3 at most, on fpn3, whose
    # level the RoI came from). So every leaf within 2e-2, and the median
    # leaf within 1e-4.
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    med = statistics.median(norms.values())
    gaps = {n: float((grads[n] - g).norm()) / max(norms[n], med)
            for n, g in ref_grads.items()}
    assert max(gaps.values()) < 2e-2, max(gaps.items(), key=lambda x: x[1])
    assert statistics.median(gaps.values()) < 1e-4


def test_half_the_batch_left_out_is_not_correct_by_the_cells_limits(steps):
    """The fault that the cell's limits are calibrated against, at the
    small size: the port's step sees the batch's first image only. Judged
    as `harness.gaps` measures a run's first step (the loss, and each
    leaf's gradient norm, a qkv bias as its thirds) by the cell's limits on
    those numbers: the sound step passes, the fault does not."""
    limits = {k: v for k, v in steps["traffic"]["limits"].items()
              if k in ("loss1_gap", "grad_p90_gap")}
    assert limits

    def first_step(losses, grads):
        # the change norms, which these limits do not read, repeat the
        # gradients' so that `harness.gaps` takes the reading whole
        norms = plain.norms(grads.items())
        return {"losses": [float(losses["loss"])], "grad_norms": norms,
                "change_norms": norms}

    ref = first_step(steps["want"], steps["ref_grads"])
    half = {k: v[:1] for k, v in steps["batch"].items()}
    fault = port_step(steps["cfg"], steps["traffic"], steps["data"],
                      steps["weights"], half, 1)
    for reading, want in ((first_step(steps["got"], steps["grads"]), True),
                          (first_step(*fault), False)):
        ok, checks = harness.judge(harness.gaps(reading, ref), limits)
        assert ok is want, checks


def test_weight_specs_name_every_leaf_of_the_port():
    from ssl4gie_tpu_torch.models.faster_rcnn import build_detector
    cfg, _ = small_cell()
    model = build_detector("vit_b", img_size=cfg["img_size"],
                           embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                           num_heads=cfg["num_heads"], device="cpu")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in program.weight_specs(cfg)} == want


def test_the_cell_sizes_its_work_from_the_published_widths():
    cfg = load("configs/vitdet_det1024.json")
    assert [a["seqs"] for a in program.attention(cfg, 48)] == [48 * 16, 48]
    assert [a["n"] for a in program.attention(cfg, 48)] == [256, 4096]
    assert [a["layers"] for a in program.attention(cfg, 48)] == [8, 4]
    # forward: 5 G patches, 696 G linear layers, 206 G global and 26 G
    # windowed attention, 253 G pyramid, 103 G RPN, 14 G box head
    assert program.flops_per_image(cfg) == pytest.approx(3 * 1.3033e12,
                                                         rel=1e-3)


def test_nms_roofline_reads_only_a_run_of_this_configuration():
    """The record names no configuration: `nms_roofline` takes k and N
    from `vitdet_det1024` only where the record's FLOPs an image and
    attention are that configuration's, and reads nothing otherwise."""
    from portbench.configs import mae_vitb16
    from portbench.metrics import nms_roofline
    cfg = load("configs/vitdet_det1024.json")
    bound = nms_work.rpn_step_bound(48, cfg)
    device = {"steps": 2, "op_seconds": {"nms_greedy_slots<2>": 2 * bound}}
    rec = {"batch": 48, "flops_per_image": program.flops_per_image(cfg),
           "attention": program.attention(cfg, 48), "device": device}
    assert nms_roofline.read(rec) == pytest.approx(100.0)
    mae = load("configs/mae_vitb16.json")
    assert nms_roofline.read(dict(
        rec, batch=256, flops_per_image=mae_vitb16.flops_per_image(mae),
        attention=mae_vitb16.attention(mae, 256))) is None
    assert nms_roofline.read(dict(rec, device=None)) is None
