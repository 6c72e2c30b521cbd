"""The benchmark's files, names and arithmetic, on the CPU.

    python -m pytest portbench/tests -q
"""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness, run, work

BENCH = harness.BENCH_DIR
SPEC = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_config_and_metric_is_found_by_name():
    for w in SPEC["workloads"]:
        c = harness.load_cell(w["name"], SPEC)
        assert c["cfg"]["name"] == w["config"]
        for fn in ("weight_specs", "flops_per_image", "attention", "build"):
            assert callable(getattr(c["program"], fn))
        assert callable(c["reference"].readings)
        assert set(c["traffic"]["limits"]) <= set(harness.gaps(
            _readings(), _readings()))
        assert c["traffic"]["limits"]
        assert c["traffic"]["pool"] >= harness.CHECK_STEPS
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for cfg in SPEC["configs"]:
        assert (harness.ROOT / cfg["file"]).is_file()
        assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def test_names_units_and_shape_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for cfg in SPEC["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        names.append(cfg["name"])
        assert all(NAME.match(k) for k in cfg["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_model_flops():
    vit = work.vit_classifier_forward_flops(224, 16, 768, 3072, 12, 12, 6)
    assert vit / 1e9 == pytest.approx(35.13, abs=0.005)
    mae = work.mae_forward_flops(224, 16, 768, 3072, 12, 12, 512, 2048, 8,
                                 16, 0.75)
    assert mae / 1e9 == pytest.approx(19.56, abs=0.01)
    assert work.train_flops(vit) == 3 * vit


def test_attention_work_counts_four_backward_products():
    fwd, fwd_bytes = work.attention_work(2, 3, 10, 8, backward=False)
    bwd, bwd_bytes = work.attention_work(2, 3, 10, 8, backward=True)
    one = 2 * 2 * 3 * 10 * 10 * 8          # one product, all heads
    assert fwd == 2 * one and bwd == 4 * one
    c = 3 * 8
    assert fwd_bytes == 2 * 2 * 10 * (3 * c + c)
    assert bwd_bytes == 2 * 2 * 10 * (3 * c + c + 3 * c)
    assert work.bound_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_nothing_imports_jax_flax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN_MODULES), path


def test_the_references_import_nothing_of_the_program():
    refs = list((BENCH / "reference").glob("*.py")) + \
        list((BENCH / "configs").glob("*_ref.py"))
    assert refs
    seen, todo = set(), refs
    while todo:           # the references and the benchmark modules they use
        path = todo.pop()
        seen.add(path)
        for m in _imports(path):
            assert m.split(".")[0] != "ssl4gie_tpu_torch", (path, m)
            if m.startswith("portbench"):
                mod = BENCH.parent / (m.replace(".", "/") + ".py")
                pkg = BENCH.parent / m.replace(".", "/")
                for p in ([mod] if mod.is_file() else
                          sorted(pkg.glob("*.py")) if pkg.is_dir() else []):
                    if p not in seen and not p.name == "__init__.py":
                        todo.append(p)


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "ssl4gie_tpu_torch_like", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert harness.forbidden_loaded() == ["flax"]


def test_trace_reading():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 70, "dur": 5, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "attn_fwd<64>", "ts": 20,
         "dur": 10, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 25,
         "dur": 10, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "copy", "ts": 80, "dur": 10,
         "args": {"correlation": 2}},
    ]
    dev = harness.device_record(ev, steps=2)
    assert dev["launches"] == 3
    assert dev["busy_s"] == pytest.approx(25e-6)
    assert dev["window_s"] == pytest.approx(70e-6)
    assert harness.idle_gaps(ev) == [["aten::copy_", pytest.approx(45e-6)]]
    rec = {"device": dev, "batch": 4, "window": None,
           "attention": [{"seqs": 1, "heads": 1, "n": 4, "dh": 8,
                          "layers": 1}]}
    assert harness.reader("launches_per_step")(rec) == 1.5
    assert harness.reader("device_idle")(rec) == pytest.approx(
        100 * (1 - 25 / 70))
    assert harness.reader("attn_roofline")(rec) > 0
    rec["device"] = dict(dev, op_seconds={"gemm": 1.0})
    assert harness.reader("attn_roofline")(rec) is None   # nothing to read
    rec["device"] = None
    for m in ("device_idle", "launches_per_step", "attn_roofline"):
        assert harness.reader(m)(rec) is None


def test_window_metrics_and_p95():
    win = {"steps": 10, "seconds": 2.0, "step_ms": [float(i) for i in
                                                    range(1, 21)],
           "memory_peak_bytes": 3 * 2 ** 30}
    rec = {"window": win, "batch": 8, "setup_s": 12.5,
           "flops_per_image": work.PEAK_BF16_FLOPS / 100, "device": None}
    assert harness.reader("train_images_per_s")(rec) == 40.0
    assert harness.reader("mfu")(rec) == pytest.approx(40.0)
    assert harness.reader("peak_mem_gib")(rec) == 3.0
    assert harness.reader("setup_s")(rec) == 12.5
    assert harness.reader("step_ms_p95")(rec) == pytest.approx(19.05)


def _readings(scale=1.0, loss=1.0):
    names = [f"l{i}" for i in range(5)]
    return {"losses": [loss] * 3,
            "grad_norms": {n: scale * (i + 1) for i, n in enumerate(names)},
            "change_norms": {n: scale * 0.1 * (i + 1)
                             for i, n in enumerate(names)}}


def test_gaps_and_judge():
    ref = _readings()
    assert harness.gaps(_readings(), ref) == dict.fromkeys(
        ("loss_gap", "loss1_gap", "grad_gap", "grad_p90_gap", "change_gap"),
        0.0)
    g = harness.gaps(_readings(scale=1.1, loss=1.01), ref)
    assert g["loss_gap"] == pytest.approx(0.01)
    assert g["grad_gap"] == pytest.approx(0.1)
    unchanged = _readings()
    unchanged["change_norms"] = dict.fromkeys(unchanged["change_norms"], 0.0)
    assert harness.gaps(unchanged, ref)["change_gap"] == pytest.approx(1.0)
    ok, checks = harness.judge(g, {"loss_gap": 0.02, "grad_gap": 0.05})
    assert not ok and list(checks) == ["loss_gap", "grad_gap"]
    assert checks["grad_gap"] == {"value": g["grad_gap"], "limit": 0.05}
    assert harness.judge(g, {"loss_gap": 0.02})[0]
    assert harness.judge({"x": float("nan")}, {"x": 1.0})[0] is False


def test_a_qkv_bias_counts_as_three_leaves_and_the_key_third_drops_out():
    import torch

    from portbench.reference import plain
    bias = torch.cat([torch.full((4,), 1.0), torch.full((4,), 2.0),
                      torch.full((4,), 3.0)])
    got = plain.norms([("b.attn.qkv.bias", bias), ("w", torch.ones(9))])
    assert got == {"b.attn.qkv.bias.q": 2.0, "b.attn.qkv.bias.k": 4.0,
                   "b.attn.qkv.bias.v": 6.0, "w": 3.0}
    ref = _readings()
    ref["grad_norms"]["b.attn.qkv.bias.k"] = 1e-9   # round-off alone
    ref["change_norms"]["b.attn.qkv.bias.k"] = 1e-6
    prog = {k: dict(v) if isinstance(v, dict) else v for k, v in ref.items()}
    prog["change_norms"]["b.attn.qkv.bias.k"] = 0.3   # AdamW's full step
    assert harness.gaps(prog, ref)["change_gap"] == 0.0
    prog["change_norms"]["l4"] *= 1.5     # one leaf moved half again
    assert harness.gaps(prog, ref)["change_gap"] == pytest.approx(0.5)


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for var in run.CACHE_VARS:
        monkeypatch.setenv(var, "")
    assert run.main(["--workload", SPEC["workloads"][0]["name"], "--seed",
                     str(2 ** 31 + 5), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
