"""Head width 80 (the MAE ViT-H preset: patch 14, 1280 wide, 16 heads) in
the port against the JAX package on the CPU: the packed-QKV attention's
plain version against the Pallas kernel in interpret mode, in float32 and
bfloat16, forward and custom VJP; `Attention` routing a ViT-H encoder's
N = 180 tokens (mask ratio 0.3) to the packed-QKV kernel; and two MAE steps
of a narrow model with ViT-H's head shape against the JAX step. The CUDA
instances (bf16 on the tensor cores, float32 on FFMAs) are held to the plain
version by the `gpu`-marked tests of `test_torch_kernels.py` and by
`chip_smoke.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention
from ssl4gie_tpu.ssl import mae as jmae
from ssl4gie_tpu.ssl import pretrain as jpre
from ssl4gie_tpu_torch.convert.from_jax import mae_params_to_torch
from ssl4gie_tpu_torch.core.config import PretrainConfig
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.models import layers
from ssl4gie_tpu_torch.ssl import mae as tmae
from ssl4gie_tpu_torch.ssl import pretrain as tpre

torch.set_num_threads(1)

DH, HEADS, N = 80, 2, 180          # ViT-H's head width; 1 + int(256 * 0.7)
SCALE = DH ** -0.5
# float32: the JAX kernel tests' 2e-4 (forward) and 2e-3 (gradient);
# bfloat16: two bf16 ulps of the element or of the largest element (the
# card tests' limit), each side rounding its f32 sums once
TOLS = {"float32": (2e-4, 2e-3), "bfloat16": (2.0 ** -6, 2.0 ** -6)}


@pytest.fixture()
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the CUDA library."""
    def refuse(*_):
        raise AssertionError("the CPU path must not build the CUDA kernels")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def _close(got, ref, dtype, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    else:
        bound = tol * (np.abs(ref) + np.abs(ref).max())
        assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_dh80_matches_pallas(dtype, no_build):
    """The wrappers on CPU tensors (the plain version) against the Pallas
    forward and custom VJP at (1, 180, 3 * 2 * 80); no launch is
    counted."""
    rng = np.random.default_rng(8)
    qkv = rng.normal(0, 1, (1, N, 3 * HEADS * DH)).astype(np.float32)
    dout = rng.normal(0, 1, (1, N, HEADS * DH)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda x: fused_qkv_attention(x, HEADS, SCALE),
                           jnp.asarray(qkv, jdt))
        (dref,) = vjp(jnp.asarray(dout, jdt))
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt)
    n0 = (da.attention_fwd.launches, da.attention_fwd.launches_f32)
    out, lse = da.attention_fwd(x, HEADS, SCALE)
    dqkv = da.attention_bwd(x, out, lse, torch.from_numpy(dout).to(tdt),
                            HEADS, SCALE)
    assert out.dtype == dqkv.dtype == tdt and lse.shape == (1, HEADS, N)
    fwd_tol, grad_tol = TOLS[dtype]
    _close(out.float().numpy(), np.asarray(ref, np.float32), dtype, fwd_tol)
    _close(dqkv.float().numpy(), np.asarray(dref, np.float32), dtype,
           grad_tol)
    assert (da.attention_fwd.launches, da.attention_fwd.launches_f32) == n0


def test_attention_dh80_routes_to_the_packed_kernel(monkeypatch):
    """A ViT-H block's attention (here 2 heads of 80) over N = 180 tokens
    takes the packed-QKV route, in float32 and bfloat16, and gives the
    head-split plain attention's output."""
    calls = []
    real = layers.fused_qkv_attention
    monkeypatch.setattr(layers, "fused_qkv_attention",
                        lambda *a: calls.append(a[1:]) or real(*a))
    x = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (2, N, HEADS * DH)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        attn = layers.Attention(HEADS * DH, HEADS, dtype=dtype).eval()
        calls.clear()
        with torch.no_grad():
            out = attn(x)
            qkv = layers.linear(x, attn.qkv, dtype)
            t = qkv.reshape(2, N, 3, HEADS, DH).permute(2, 0, 3, 1, 4)
            ref = layers.plain_attention(t[0].float(), t[1].float(),
                                         t[2].float(), SCALE)
            ref = layers.linear(ref.transpose(1, 2).reshape(2, N, -1).to(
                dtype), attn.proj, dtype)
        assert calls == [(HEADS, SCALE)]
        assert out.shape == (2, N, HEADS * DH) and out.dtype == dtype
        tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
        bound = tol * (ref.float().abs() + ref.float().abs().max())
        assert bool(((out.float() - ref.float()).abs() <= bound).all())


# ViT-H's patch and head shape at narrow width: 224 px / 14 = 16 x 16
# patches, 2 heads of 80, depth 2; mask 0.3 keeps 179 patches, so the
# encoder attends over 180 tokens (the packed-QKV route at Dh 80) and the
# decoder over 257 (the packed-QKV route at Dh 32)
VIT_H_NARROW = dict(img_size=224, patch_size=14, embed_dim=HEADS * DH,
                    depth=2, num_heads=HEADS, decoder_embed_dim=64,
                    decoder_depth=2, decoder_num_heads=2, mask_ratio=0.3)
B, L = 2, 256


def _key_bias(name, p):
    """The key slice of a qkv bias: its exact gradient is 0 (softmax ignores
    a per-row shift), so its rounding noise takes either sign."""
    if not name.endswith("attn.qkv.bias"):
        return None
    C = p.shape[0] // 3
    return slice(C, 2 * C)


def test_mae_vit_h_head_shape_two_steps_match_jax(monkeypatch):
    """Two MAE steps (loss, backward, AdamW at the warmup-cosine rate) of
    the narrow ViT-H-shaped model against the JAX step with optax, from one
    weight set, the same images and one mask noise per step: loss and
    gradient norm within 1e-5 relative, every parameter after the second
    step within 1e-5 of the largest (the key biases, whose exact gradient
    is 0, within 2 lr). Every encoder and decoder attention goes through
    the packed-QKV route (its plain version here)."""
    import optax
    warmup, total, peak = 1, 10, 1e-3
    model = jmae.MAE(dtype=jnp.float32, **VIT_H_NARROW)
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        {"params": key, "mask": key},
        jnp.zeros((1, 224, 224, 3), jnp.float32))["params"])
    x = np.random.default_rng(1).normal(0, 1, (B, 224, 224, 3)).astype(
        np.float32)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    schedule = jpre.make_schedule(peak, warmup, total)
    tx = optax.adamw(schedule, b1=0.9, b2=0.95, weight_decay=0.05,
                     mask=jpre.wd_mask(params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    ref = []
    for k in keys:
        loss, g = jax.value_and_grad(lambda p: model.apply(
            {"params": p}, jnp.asarray(x), rng=k)[0])(jp)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ref.append((float(loss), float(optax.global_norm(g))))

    routed = []
    real = layers.fused_qkv_attention
    monkeypatch.setattr(layers, "fused_qkv_attention",
                        lambda q, h, s: routed.append(
                            (q.shape[1], q.shape[2] // (3 * h))) or
                        real(q, h, s))
    tmodel = tmae.MAE(device="cpu", **VIT_H_NARROW)
    tmodel.load_state_dict(mae_params_to_torch(params))
    opt = tpre.make_mae_optimizer(tmodel, PretrainConfig(weight_decay=0.05))
    step = tpre.make_mae_train_step(tpre.make_schedule(peak, warmup, total))
    for i, k in enumerate(keys):
        noise = torch.from_numpy(np.array(jax.random.uniform(k, (B, L))))
        out = step(tmodel, opt, torch.from_numpy(x), noise, i)
        np.testing.assert_allclose(out["loss"].item(), ref[i][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"].item(), ref[i][1],
                                   rtol=1e-5)
    # each step: 2 encoder blocks at (180, Dh 80), 2 decoder blocks at
    # (257, Dh 32)
    assert routed == 2 * ([(N, DH)] * 2 + [(L + 1, 32)] * 2)
    want = mae_params_to_torch(jax.tree_util.tree_map(np.asarray, jp))
    largest = max(np.abs(v.numpy()).max() for v in want.values())
    lr = schedule(1)
    for name, p in tmodel.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        kb = _key_bias(name, p)
        if kb is not None:
            assert err[kb].max() <= 2 * lr * (1 + 1e-3), name
            err[kb] = 0
        assert err.max() <= 1e-5 * largest, (name, err.max())
