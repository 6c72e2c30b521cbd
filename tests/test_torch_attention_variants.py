"""The port's attention A/B variants (`ssl4gie_tpu_torch/kernels/
attention_variants.py`: #10 packed-QKV v2, #11 save-P, #12 window v2) and
kernel harnesses (`ssl4gie_tpu_torch/benchmarks/`) against the JAX
package's harness kernels (`benchmarks/bench_attention_kernel.py`,
`benchmarks/bench_window_kernel.py`), run in Pallas interpret mode on the
CPU on the same seeded inputs; and the bf16 parity of the production
attention kernels' plain versions (#1/#2, #4/#5) with the Pallas kernels.
The JAX harness modules build their inputs at import, so they are loaded by
path at a small batch. The CUDA kernels themselves are checked by the
`gpu`-marked tests (skipped without a card) and by `chip_smoke.py`."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu_torch.benchmarks import bench_attention_kernel as bak
from ssl4gie_tpu_torch.benchmarks import bench_window_kernel as bwk
from ssl4gie_tpu_torch.benchmarks import resolve_device
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import attention_variants as av
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import window_attention as wa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
H, DH, N = 12, 64, 197               # the JAX harnesses' fixed shapes
C = H * DH
SCALE = DH ** -0.5
FWD_TOL, GRAD_TOL = 2e-4, 2e-3       # f32, as tests/test_torch_kernels.py
BF16_TOL = 2.0 ** -6                 # of the largest element: two bf16 ulps
COUNTERS = (av.attention_v2_fwd, av.attention_v2_bwd, av.attention_save_p_fwd,
            av.attention_save_p_bwd, av.window_v2_fwd, av.window_v2_bwd,
            da.attention_fwd, da.attention_bwd, wa.window_attention_fwd,
            wa.window_attention_bwd)


@pytest.fixture()
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the CUDA library."""
    def refuse(*_):
        raise AssertionError("the CPU path must not build the CUDA kernels")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load(name: str, env: str, batch: str):
    """The JAX harness module `benchmarks/<name>.py`, imported by path with
    its batch set to `batch` (it builds its input at import)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(env, batch)
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", REPO / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_attn():
    return _load("bench_attention_kernel", "ATTN_BENCH_B", "2")


@pytest.fixture(scope="module")
def jax_window():
    return _load("bench_window_kernel", "WATTN_BENCH_B", "1")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    dout = rng.normal(0, 1, shape[:-1] + (shape[-1] // 3,)).astype(np.float32)
    return x, dout


def _jax_vjp(fn, x, dout, dtype, params=None):
    """fn's forward and its vjp of dout, in Pallas interpret mode, as f32
    numpy arrays."""
    with pltpu.force_tpu_interpret_mode(params or pltpu.InterpretParams()):
        out, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
        (g,) = vjp(jnp.asarray(dout, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(g.astype(jnp.float32)))


def _torch_vjp(fn, x, dout, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = fn(xt)
    (g,) = torch.autograd.grad(out, xt, torch.from_numpy(dout).to(dtype))
    return out.detach().float().numpy(), g.float().numpy()


def _assert_close(got, ref, dtype, tol=None, what=""):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)
    else:
        err = np.abs(got - ref).max()
        assert err <= BF16_TOL * np.abs(ref).max(), (what, err,
                                                     np.abs(ref).max())


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
ZERO_FILL = pltpu.InterpretParams(uninitialized_memory="zero")
# case -> (JAX harness, its kernel, the port's layer, interpret params)
CASES = {
    "v2": ("attn", lambda m: m._mk_v2(2, 2), bak.v2_layer(2, 2), None),
    "v3": ("attn", lambda m: m._mk_v2(2, 2, Nb=208), bak.v2_layer(2, 2, 208),
           None),
    # the reference's padded P rows are read uninitialised (see
    # test_save_p_reference_fault): zero-filled memory here
    "v4": ("attn", lambda m: m._mk_v4(2, 2), bak.v4_layer(), ZERO_FILL),
    "window_g1": ("window", lambda m: m._mk_v2(1), bwk.v2_layer(1), None),
    "window_g2": ("window", lambda m: m._mk_v2(2), bwk.v2_layer(2), None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_pallas(case, dtype, jax_attn, jax_window,
                                     no_build):
    """Forward and gradient of each variant's plain version (through the
    port's autograd Function on CPU tensors) against the JAX harness
    kernel: f32 at 2e-4 / 2e-3, bf16 at 2^-6 of the largest element. No
    launch is counted."""
    where, make, layer, params = CASES[case]
    mod = jax_attn if where == "attn" else jax_window
    shape = (2, N, 3 * C) if where == "attn" else (1, 64, 64, 3 * C)
    x, dout = _inputs(shape, 7)
    tdt, jdt = DTYPES[dtype]
    ref, g_ref = _jax_vjp(make(mod), x, dout, jdt, params)
    before = [fn.launches for fn in COUNTERS]
    out, g = _torch_vjp(layer, x, dout, tdt)
    _assert_close(out, ref, tdt, FWD_TOL, "forward")
    _assert_close(g, g_ref, tdt, GRAD_TOL, "gradient")
    assert [fn.launches for fn in COUNTERS] == before


def test_save_p_reference_fault(jax_attn, no_build):
    """The reference's save-P backward contracts over P's rows >= n, which
    its forward computes from out-of-bounds q rows: with uninitialised
    memory filled with NaN (the interpreter's default) its dqkv is not
    finite. The port never writes or reads those rows: its save-P gradient
    on the same bf16 input is finite and equals #2's."""
    x, dout = _inputs((2, N, 3 * C), 3)
    _, g_ref = _jax_vjp(jax_attn._mk_v4(2, 2), x, dout, jnp.bfloat16)
    assert not np.isfinite(g_ref).all()
    _, g = _torch_vjp(bak.v4_layer(), x, dout, torch.bfloat16)
    _, g2 = _torch_vjp(bak.fused_layer, x, dout, torch.bfloat16)
    assert np.isfinite(g).all()
    _assert_close(g, g2, torch.bfloat16)


def test_save_p_forward_returns_p(no_build):
    """#11's forward on a CPU tensor returns P (B, H, N, Nb) whose columns
    >= N are zero and whose rows sum to one."""
    x, _ = _inputs((2, N, 3 * C), 5)
    out, p = av.attention_save_p_fwd(torch.from_numpy(x), H, SCALE, 2, 208)
    assert out.shape == (2, N, C) and p.shape == (2, H, N, 208)
    assert not p[..., N:].any()
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "window"])
def test_production_plain_versions_match_pallas_in_bf16(kind, no_build):
    """The plain versions of #1/#2 and #4/#5 in bf16 against the Pallas
    kernels in bf16 (interpret mode): forward and gradient within 2^-6 of
    the largest element."""
    from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention
    from ssl4gie_tpu.kernels.window_attention import windowed_flash_attention
    if kind == "dense":
        x, dout = _inputs((2, N, 3 * C), 11)
        jfn = lambda t: fused_qkv_attention(t, H, SCALE)
        tfn = lambda t: da.fused_qkv_attention(t, H, SCALE)
    else:
        x, dout = _inputs((1, 64, 64, 3 * C), 13)
        jfn = lambda t: windowed_flash_attention(t, H, 16, SCALE)
        tfn = lambda t: wa.windowed_flash_attention(t, H, 16, SCALE)
    ref, g_ref = _jax_vjp(jfn, x, dout, jnp.bfloat16)
    out, g = _torch_vjp(tfn, x, dout, torch.bfloat16)
    _assert_close(out, ref, torch.bfloat16, what="forward")
    _assert_close(g, g_ref, torch.bfloat16, what="gradient")


HARNESS_LEGS = ([("attn", leg) for leg in bak.LEGS]
                + [("window", leg) for leg in bwk.LEGS])


@pytest.mark.parametrize("harness,leg", HARNESS_LEGS)
def test_harness_legs_run_on_cpu(harness, leg, no_build):
    """Two steps of each leg on the CPU at B = 2, L = 2: finite losses, and
    no kernel launched or built."""
    mod = bak if harness == "attn" else bwk
    before = [fn.launches for fn in COUNTERS]
    x0 = mod.make_x0(2, torch.device("cpu"))
    res = mod.bench(leg, x0, L=2, steps=1, card="cpu", warmup=1)
    assert res["steps_run"] == 2 and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all() and res["ms_step"] > 0
    assert [fn.launches for fn in COUNTERS] == before


KERNEL_LEGS = [(h, leg) for h, leg in HARNESS_LEGS
               if (bak if h == "attn" else bwk).LEGS[leg].plain is not None]


@pytest.mark.parametrize("harness,leg", KERNEL_LEGS)
def test_harness_leg_plain_matches_its_layer_on_cpu(harness, leg, no_build):
    """What `chip_smoke.py` holds each kernel leg against on the card: the
    leg's `plain` gives its layer's output and gradient (here, on the CPU,
    the layer runs the plain versions too), and the configurations it
    names for its kernels are the ones its layer passes them."""
    mod = bak if harness == "attn" else bwk
    spec = mod.LEGS[leg]
    x0 = mod.make_x0(2 if harness == "attn" else 1, torch.device("cpu"))
    _, dout = _inputs(tuple(x0.shape), 17)
    dout = torch.from_numpy(dout).to(x0.dtype)
    x = x0.clone().requires_grad_(True)
    out = spec.layer(x)
    (g,) = torch.autograd.grad(out, x, dout)
    ref_out, ref_g = spec.plain(x0, dout)
    _assert_close(out.detach().float().numpy(), ref_out.float().numpy(),
                  torch.bfloat16, what="forward")
    _assert_close(g.float().numpy(), ref_g.float().numpy(), torch.bfloat16,
                  what="gradient")
    kw = getattr(spec.layer, "keywords", {})
    for fn, config in spec.kernels:
        if config is None:
            continue
        if "G" in kw:
            assert config == kw["G"]
        else:
            side = "fwd_G" if fn.__name__.endswith("_fwd") else "bwd_G"
            assert config == (kw[side], kw["Nb"])


def test_harness_cli_on_cpu(monkeypatch, capsys, no_build):
    """The command line with --device cpu: the parity leg and the timed leg
    print their lines; the parity of v4 against #1/#2 holds to bf16."""
    monkeypatch.setenv("ATTN_BENCH_B", "2")
    monkeypatch.setenv("ATTN_BENCH_L", "1")
    monkeypatch.setenv("ATTN_BENCH_STEPS", "1")
    res = bak.run("v4", "cpu")
    err_f, err_g = res["check"]["v4"]
    assert err_f < 0.05 and err_g < 0.05
    bak.main(["fused", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("variant parity vs current")
    assert lines[1].startswith("v4 save-P") and lines[-1].startswith("fused")


def test_harness_needs_a_card_or_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_backward_ablation_needs_a_card():
    """`benchmarks/ablate_resident_backward.py` measures only on the card:
    without one it stops before building anything."""
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    from ssl4gie_tpu_torch.benchmarks import ablate_resident_backward as arb
    with pytest.raises(SystemExit, match="no CUDA device"):
        arb.main()


@pytest.mark.parametrize("bad", ["dh", "block", "n", "dtype", "window_g"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    """The checks the wrappers make before a launch, on a meta tensor
    standing in for the card's (no memory, no launch)."""
    kw = {"device": "meta", "dtype": torch.bfloat16}
    if bad == "window_g":
        qkv = torch.empty((1, 64, 64, 3 * C), **kw)
        with pytest.raises(ValueError, match="does not divide"):
            av.window_attention_v2(qkv, H, 16, SCALE, G=3)
        return
    shape, block = (2, N, 3 * C), 256
    if bad == "dh":
        shape = (2, N, 3 * 8 * 32)
    elif bad == "block":
        block = 224
    elif bad == "n":
        shape = (2, 257, 3 * C)
    elif bad == "dtype":
        kw["dtype"] = torch.float32
    with pytest.raises((ValueError, TypeError)):
        av._check_dense(torch.empty(shape, **kw), H if bad != "dh" else 8,
                        block)


# ------------------------------------------------------------ on the card
def _rand(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _close(name, got, ref):
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all()), name
    err = (got - ref).abs().max().item()
    assert err <= BF16_TOL * ref.abs().max().item(), (name, err)


LSE_TOL = 2.0 ** -16                 # the log-sum-exp, relative


def _close_lse(got, ref):
    """Each element within LSE_TOL * (|ref| + max|ref|), as chip_smoke.py's
    check_close holds the kernels' float32 outputs."""
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs()
    assert bool((err <= LSE_TOL * (ref.abs() + ref.abs().max())).all()), \
        err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,batch,n,block,G", [
    ("v2", 4, 197, 256, 2), ("v2", 3, 256, 256, 1), ("v2", 2, 100, 256, 2),
    ("v2", 2, 1, 256, 1), ("v2", 4, 197, 208, 2), ("v2", 2, 208, 208, 4),
    # the persistent forward's edges: N about a 64-row tile, sequences not a
    # multiple of G, more work items (B H / G) than the card has SMs
    ("v2", 5, 1, 208, 2), ("v2", 3, 63, 256, 2), ("v2", 5, 64, 208, 4),
    ("v2", 3, 65, 256, 2), ("v2", 7, 197, 256, 4), ("v2", 5, 208, 208, 2),
    ("v2", 3, 256, 256, 2), ("v2", 64, 197, 256, 1), ("v2", 64, 197, 208, 4),
    ("save_p", 4, 197, 208, 2), ("save_p", 3, 50, 208, 1),
    ("save_p", 2, 208, 208, 4),
    # the same edges of the persistent save-P kernels: a box of P holding
    # only rows >= N, key tiles past N, more work items than SMs
    ("save_p", 5, 1, 208, 2), ("save_p", 3, 63, 208, 2),
    ("save_p", 5, 64, 208, 4), ("save_p", 3, 65, 208, 2),
    ("save_p", 7, 197, 208, 4), ("save_p", 5, 208, 208, 2),
    ("save_p", 64, 197, 208, 2), ("save_p", 64, 197, 208, 1),
])
def test_dense_variants_match_plain_on_card(cuda, kind, batch, n, block, G):
    """#10 and #11: forward, P and backward against the plain versions at
    2^-6 of the largest element, #10's lse at 2^-16 relative."""
    gen = torch.Generator(device=cuda).manual_seed(batch * 1000 + n)
    qkv, dout = _rand((batch, n, 3 * C), gen, cuda), _rand((batch, n, C),
                                                            gen, cuda)
    if kind == "v2":
        out, lse = av.attention_v2_fwd(qkv, H, SCALE, G, block)
        out_p, lse_p = av.packed_attention_v2_fwd_plain(qkv, H, SCALE)
        _close_lse(lse, lse_p)
        dq = av.attention_v2_bwd(qkv, out, lse, dout, H, SCALE, G, block)
        dq_p = av.packed_attention_v2_bwd_plain(qkv, dout, H, SCALE)
    else:
        out, p = av.attention_save_p_fwd(qkv, H, SCALE, G, block)
        out_p, p_p = av.packed_attention_save_p_fwd_plain(qkv, H, SCALE,
                                                          block)
        _close("p", p, p_p)
        dq = av.attention_save_p_bwd(qkv, p, dout, H, SCALE, G)
        dq_p = av.packed_attention_save_p_bwd_plain(qkv, p, dout, H, SCALE)
    torch.cuda.synchronize()
    _close("out", out, out_p)
    _close("dqkv", dq, dq_p)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,grid,window,G", [
    (2, 64, 16, 1), (2, 64, 16, 2), (1, 64, 16, 4), (2, 32, 8, 2),
    # more work items than SMs; windows of 64 tokens (one query tile) at
    # each G; 14 x 14 windows (a tile boundary inside a window row)
    (4, 64, 16, 1), (3, 32, 8, 1), (1, 32, 8, 4), (2, 28, 14, 2)])
def test_window_v2_matches_plain_on_card(cuda, batch, grid, window, G):
    gen = torch.Generator(device=cuda).manual_seed(grid + G)
    qkv = _rand((batch, grid, grid, 3 * C), gen, cuda)
    dout = _rand((batch, grid, grid, C), gen, cuda)
    out, lse = av.window_v2_fwd(qkv, H, window, SCALE, G)
    out_p, lse_p = av.window_attention_v2_fwd_plain(qkv, H, window, SCALE)
    dq = av.window_v2_bwd(qkv, out, lse, dout, H, window, SCALE, G)
    dq_p = av.window_attention_v2_bwd_plain(qkv, dout, H, window, SCALE)
    torch.cuda.synchronize()
    _close("out", out, out_p)
    _close_lse(lse, lse_p)
    _close("dqkv", dq, dq_p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["v2", "v3", "save_p", "window"])
def test_groups_repeat_bit_for_bit_on_card(cuda, kind):
    """G sequences a block changes only the order of the work: G = 1 and
    G = 2 (and 4 for the windows) give the same bits, forward and
    gradient."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (1, 64, 64, 3 * C) if kind == "window" else (4, N, 3 * C)
    x = _rand(shape, gen, cuda)
    dout = _rand(shape[:-1] + (C,), gen, cuda)
    fn = {"v2": lambda t, G: av.packed_attention_v2(t, H, SCALE, G, G, 256),
          "v3": lambda t, G: av.packed_attention_v2(t, H, SCALE, G, G, 208),
          "save_p": lambda t, G: av.packed_attention_save_p(t, H, SCALE, G,
                                                            G, 208),
          "window": lambda t, G: av.window_attention_v2(t, H, 16, SCALE, G)}
    outs = []
    for G in (1, 2, 4):
        xt = x.detach().requires_grad_(True)
        out = fn[kind](xt, G)
        (g,) = torch.autograd.grad(out, xt, dout)
        outs.append((out, g))
    for out, g in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(g, outs[0][1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["v2", "v3", "save_p", "window"])
def test_forward_repeats_bit_for_bit_on_card(cuda, kind):
    """The persistent forward of #10 / #11 / #12 twice on the same input,
    at every G the harnesses use: the same bits (no atomics, one order;
    #11's second output is P)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    if kind == "window":
        x = _rand((4, 64, 64, 3 * C), gen, cuda)
        runs = [(G, [av.window_v2_fwd(x, H, 16, SCALE, G) for _ in range(2)])
                for G in (1, 2, 4)]
    elif kind == "save_p":
        x = _rand((64, N, 3 * C), gen, cuda)
        runs = [(G, [av.attention_save_p_fwd(x, H, SCALE, G, 208)
                     for _ in range(2)]) for G in (1, 2, 4)]
    else:
        block = 256 if kind == "v2" else 208
        x = _rand((64, N, 3 * C), gen, cuda)
        runs = [(G, [av.attention_v2_fwd(x, H, SCALE, G, block)
                     for _ in range(2)]) for G in (2, 4)]
    torch.cuda.synchronize()
    for G, ((o1, l1), (o2, l2)) in runs:
        assert torch.equal(o1, o2) and torch.equal(l1, l2), G


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["v2", "v3", "save_p", "window"])
def test_backward_repeats_bit_for_bit_on_card(cuda, kind):
    """The fused backward of #10 / #11 / #12 twice on the same input, at
    every G the harnesses use: the same bits (dQ's partials are summed in
    one fixed order, no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    if kind == "window":
        x = _rand((4, 64, 64, 3 * C), gen, cuda)
        dout = _rand((4, 64, 64, C), gen, cuda)
        out, lse = av.window_v2_fwd(x, H, 16, SCALE)
        runs = [(G, [av.window_v2_bwd(x, out, lse, dout, H, 16, SCALE, G)
                     for _ in range(2)]) for G in (1, 2, 4)]
    elif kind == "save_p":
        x = _rand((64, N, 3 * C), gen, cuda)
        dout = _rand((64, N, C), gen, cuda)
        _, p = av.attention_save_p_fwd(x, H, SCALE, 2, 208)
        runs = [(G, [av.attention_save_p_bwd(x, p, dout, H, SCALE, G)
                     for _ in range(2)]) for G in (1, 2, 4)]
    else:
        block = 256 if kind == "v2" else 208
        x = _rand((64, N, 3 * C), gen, cuda)
        dout = _rand((64, N, C), gen, cuda)
        out, lse = av.attention_v2_fwd(x, H, SCALE, 2, block)
        runs = [(G, [av.attention_v2_bwd(x, out, lse, dout, H, SCALE, G,
                                         block) for _ in range(2)])
                for G in (2, 4)]
    torch.cuda.synchronize()
    for G, (g1, g2) in runs:
        assert torch.equal(g1, g2), G


@pytest.mark.gpu
@pytest.mark.parametrize("n", [150, N])
def test_save_p_backward_ignores_columns_past_n_on_card(cuda, n):
    """P's columns >= N hold garbage (large values, inf and NaN): the save-P
    backward gives the plain backward's dqkv, which reads P's first N
    columns only."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv, dout = _rand((6, n, 3 * C), gen, cuda), _rand((6, n, C), gen, cuda)
    _, p = av.attention_save_p_fwd(qkv, H, SCALE, 2, 208)
    junk = 1e4 * torch.randn(p[..., n:].shape, generator=gen, device=cuda)
    junk[..., ::5] = float("nan")
    junk[..., 1::7] = float("inf")
    p[..., n:] = junk.to(p.dtype)
    dq = av.attention_save_p_bwd(qkv, p, dout, H, SCALE, 2)
    dq_p = av.packed_attention_save_p_bwd_plain(qkv, p, dout, H, SCALE)
    torch.cuda.synchronize()
    _close("dqkv", dq, dq_p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,block", [("v2", 256), ("v2", 208),
                                        ("window", 256)])
def test_backward_holds_rows_of_tiny_lse_on_card(cuda, kind, block):
    """Rows whose scores are all far below zero (lse < -87, where exp(-lse)
    overflows float32) beside masked keys (N < Nb; 14 x 14 windows): the
    kernel's gradient is finite and matches the plain version at 2^-6."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    shape = (2, 28, 28, 3 * C) if kind == "window" else (3, N, 3 * C)
    x = _rand(shape, gen, cuda).float()
    q, k, v = x.split(C, dim=-1)
    u = torch.randn((H, DH), generator=gen, device=cuda)
    # every key of a head near u, the queries of every other row -12.5 u:
    # scores about -12.5 |u|^2 / 8 = -100
    k = u.reshape(C) + 0.1 * k
    q = torch.where(torch.arange(q.shape[-2], device=cuda)[:, None] % 2 == 0,
                    -12.5 * u.reshape(C) + 0.1 * q, q)
    x = torch.cat([q, k, v], dim=-1).to(torch.bfloat16)
    dout = _rand(shape[:-1] + (C,), gen, cuda)
    if kind == "window":
        out, lse = av.window_v2_fwd(x, H, 14, SCALE)
        dq = av.window_v2_bwd(x, out, lse, dout, H, 14, SCALE)
        dq_p = av.window_attention_v2_bwd_plain(x, dout, H, 14, SCALE)
    else:
        out, lse = av.attention_v2_fwd(x, H, SCALE, 2, block)
        dq = av.attention_v2_bwd(x, out, lse, dout, H, SCALE, 2, block)
        dq_p = av.packed_attention_v2_bwd_plain(x, dout, H, SCALE)
    torch.cuda.synchronize()
    assert lse.min().item() < -87
    _close("dqkv", dq, dq_p)


@pytest.mark.gpu
def test_variant_kernels_reject_what_they_do_not_take(cuda):
    qkv = torch.zeros((2, N, 3 * C), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        av.attention_v2_fwd(qkv.float(), H, SCALE)
    with pytest.raises(ValueError):
        av.attention_v2_fwd(qkv, 24, SCALE)             # Dh 32
    with pytest.raises(ValueError):
        av.attention_v2_fwd(torch.zeros((2, 257, 3 * C), device=cuda,
                                        dtype=torch.bfloat16), H, SCALE)
    for block in (192, 256):
        with pytest.raises(ValueError):
            av.attention_save_p_fwd(qkv, H, SCALE, 2, block)
