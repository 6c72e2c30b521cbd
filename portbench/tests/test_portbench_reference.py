"""The comparison that decides `correct`, driven through a whole run on the
CPU at a tiny width: the plain reference against the port's CPU path on the
same weights and inputs, and the faults that must make `correct` false.

The same code runs on the card at the cells' sizes; `test_cell_on_the_card`
runs a cell there and reads its last line.
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, harness, run

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def with_standby() -> dict:
    """BENCHMARK.json with the cells whose files are kept but which it does
    not run (PERF.md, Open questions), so that their references stay
    tested against the port."""
    bench = harness.load_benchmark()
    configs = {c["name"] for c in bench["configs"]}
    for path in sorted((harness.BENCH_DIR / "workloads").glob("*.json")):
        if path.stem in CELLS:
            continue
        config, traffic = path.stem.split(".", 1)
        if config not in configs:
            configs.add(config)
            bench["configs"].append({"name": config,
                                     "file": f"portbench/configs/{config}.json"})
        bench["workloads"].append({"name": path.stem, "config": config,
                                   "traffic": traffic, "chips": 1})
    return bench


STANDBY = [w["name"] for w in with_standby()["workloads"]
           if w["name"] not in CELLS]
SEED = 2 ** 31 + 2 ** 20 + 17
TINY = {"embed_dim": 64, "depth": 2, "num_heads": 2, "mlp_dim": 256}
TINY_DECODER = {"decoder_embed_dim": 32, "decoder_depth": 2,
                "decoder_num_heads": 2, "decoder_mlp_dim": 128}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell: str, compute_dtype: str = "float32") -> dict:
    """The cell at a tiny width and batch on the CPU; the images keep their
    size, so the step takes the same routes (197 tokens: the packed-QKV
    attention's plain version)."""
    c = harness.load_cell(cell, with_standby())
    cfg = dict(c["cfg"], **TINY, compute_dtype=compute_dtype)
    if "decoder_embed_dim" in cfg:
        cfg.update(TINY_DECODER)
    c["cfg"] = cfg
    c["traffic"] = dict(c["traffic"], batch=4)
    return c


@pytest.mark.parametrize("cell", CELLS + STANDBY)
def test_reference_agrees_with_the_port_in_float32(cell):
    """Same weights, batches and draws: the port's CPU path in float32
    against the reference, to float32 rounding."""
    out = run.run(tiny(cell), SEED, 0.5, False, device="cpu")
    assert out["correct"]
    for name, chk in out["checks"].items():
        assert chk["value"] < 2e-5, (name, chk)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_a_run_prints_the_cells_metrics():
    out = run.run(tiny(CELLS[0]), SEED, 0.5, False, device="cpu")
    names = [m["name"] for m in harness.metrics_for(
        harness.load_benchmark()["end_to_end"], CELLS[0])]
    assert sorted(out["metrics"]) == sorted(names)
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    build = harness.build

    def broken(c, seed, device):
        data, prog = build(c, seed, device)
        return data, calibrate.half_batch(prog)

    monkeypatch.setattr(harness, "build", broken)
    out = run.run(tiny(cell), SEED, 0.5, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell,
                                                               monkeypatch):
    build = harness.build

    def broken(c, seed, device):
        data, prog = build(c, seed, device)
        prog.optimizer.step = lambda *a, **k: None
        return data, prog

    monkeypatch.setattr(harness, "build", broken)
    out = run.run(tiny(cell), SEED, 0.5, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > 0.9


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control, the reference put in the program's place in fp8, and
    the same with the augmentation in float32, judged by the cell's limits
    at a tiny width: not correct, while the program in its own precision
    is. `calibrate.py` reads them on the card at the cell's sizes."""
    c = tiny(cell, "bfloat16")
    lines, _ = calibrate.calibrate(c, 1, 1, 0, SEED, "cpu", model_control=1)
    verdict = {ln["kind"]: harness.judge(ln, c["traffic"]["limits"])[0]
               for ln in lines}
    assert verdict == {"sound": True, "control": False,
                       "model_control": False}


@pytest.mark.gpu
def test_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         CELLS[-1], "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
