"""Plain PyTorch pieces of the references: linear layers, attention,
pre-norm blocks, AdamW and the readings a training check compares.

Imports nothing of the program. Weights are a dict of float32 tensors
under timm's names. Every matrix product goes through `matmul`, which
computes in float32 or, for the control, in fp8: both operands rounded to
float8 e4m3 with one scale a tensor (the incoming gradient to e5m2 in the
backward), products and sums in float32. The control's augmentation
rounds each result to e4m3 (`rounding`); what the program computes in
float32 (LayerNorm, softmax, the head, the loss) stays float32. The
precision `fp8_model` computes the products in fp8 and the augmentation
in float32: a reading of the model's layers alone.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8", "fp8_model")


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (a float8 type) under one scale that maps its
    largest magnitude to the type's largest value, back in x's dtype."""
    amax = x.detach().abs().amax().to(torch.float32).clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        da = qg @ qb.transpose(-2, -1)
        if qb.dim() == 2 and qa.dim() > 2:     # a weight shared by the rows
            db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1,
                                                                qg.shape[-1])
        else:
            db = qa.transpose(-2, -1) @ qg
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision in ("fp8", "fp8_model"):
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def rounding(precision: str):
    """What the control does to each result of the augmentation, which the
    program computes in bfloat16: nothing in float32 (None), fp8 e4m3
    rounding under one scale a tensor in fp8."""
    if precision in ("float32", "fp8_model"):
        return None
    if precision == "fp8":
        return lambda x: _fp8(x, torch.float8_e4m3fn)
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def linear(x, weight, bias, precision: str):
    return matmul(x, weight.t(), precision) + bias


def layer_norm(x, w: dict, name: str):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-6)


def patch_embed(img: torch.Tensor, weight, bias, patch: int,
                precision: str) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, L, D): the 16 x 16 stride-16 convolution as
    a product over each patch's pixels in the conv weight's (c, kh, kw)
    order, patches row by row."""
    B, H, W, C = img.shape
    gh, gw = H // patch, W // patch
    x = img.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(B, gh * gw, C * patch * patch)
    return linear(x, weight.reshape(weight.shape[0], -1), bias, precision)


def block(x, w: dict, name: str, heads: int, precision: str):
    """timm's pre-norm `Block` (qkv with bias, exact GELU), no dropout."""
    B, N, D = x.shape
    dh = D // heads
    h = layer_norm(x, w, name + ".norm1")
    qkv = linear(h, w[name + ".attn.qkv.weight"], w[name + ".attn.qkv.bias"],
                 precision)
    q, k, v = qkv.reshape(B, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    s = matmul(q, k.transpose(-2, -1), precision) * dh ** -0.5
    o = matmul(torch.softmax(s, dim=-1), v, precision)
    o = o.transpose(1, 2).reshape(B, N, D)
    x = x + linear(o, w[name + ".attn.proj.weight"],
                   w[name + ".attn.proj.bias"], precision)
    h = layer_norm(x, w, name + ".norm2")
    h = F.gelu(linear(h, w[name + ".mlp.fc1.weight"],
                      w[name + ".mlp.fc1.bias"], precision))
    return x + linear(h, w[name + ".mlp.fc2.weight"],
                      w[name + ".mlp.fc2.bias"], precision)


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter), bias-corrected,
    on a dict of float32 leaves; `decay(name, p)` says which leaves decay."""

    def __init__(self, params: dict, b1: float, b2: float, eps: float,
                 weight_decay: float, decay=lambda name, p: True):
        self.params, self.b1, self.b2, self.eps = params, b1, b2, eps
        self.wd = {n: weight_decay if decay(n, p) else 0.0
                   for n, p in params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd[n])
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def leaf_norms(name: str, t: torch.Tensor) -> dict:
    """The norm of the leaf `name` (a parameter, its gradient or its
    change), a qkv bias as three leaves, its query, key and value thirds
    (`<name>.q`, `.k`, `.v`): the key bias's gradient is nought but for
    round-off under softmax, and a rule on the gradient can leave out that
    third alone."""
    t = t.detach()
    if name.endswith("attn.qkv.bias"):
        return {f"{name}.{part}": float(third.norm())
                for part, third in zip("qkv", t.chunk(3))}
    return {name: float(t.norm())}


def norms(tensors) -> dict:
    """`leaf_norms` of each (name, tensor) pair, taken one at a time."""
    return {k: v for n, t in tensors for k, v in leaf_norms(n, t).items()}


def train_readings(params: dict, loss_fn, batches, lrs, optimizer: AdamW
                   ) -> dict:
    """Run len(batches) steps of `loss_fn(params, batch)` and AdamW at the
    rates `lrs`. Returns each step's loss, each leaf's gradient norm in the
    first step and each leaf's change norm after the last (`leaf_norms`)."""
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, grad_norms = [], {}
    for i, (batch, lr) in enumerate(zip(batches, lrs)):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves.keys(), grads))
        if i == 0:
            grad_norms = norms(grads.items())
        losses.append(float(loss.detach()))
        optimizer.step(grads, lr)
        del loss, grads, leaves
    changes = norms((n, p - start[n]) for n, p in params.items())
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": changes}


@contextlib.contextmanager
def no_tf32():
    """A context in which float32 products on the card stay float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sincos_1d(pos, dim: int):
    """[sin(pos omega), cos(pos omega)], omega = 10000^(-i / (dim / 2))."""
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64)
                            / (dim / 2.0))
    out = pos.to(torch.float64)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """(1 + grid^2, dim) float32: a zero row for cls, then per patch (row
    by row) the row coordinate's table in the first half and the column's
    in the second."""
    rows = torch.arange(grid).repeat_interleave(grid)
    cols = torch.arange(grid).repeat(grid)
    pos = torch.cat([sincos_1d(rows, dim // 2), sincos_1d(cols, dim // 2)],
                    dim=1)
    return torch.cat([torch.zeros(1, dim, dtype=torch.float64), pos]).to(
        torch.float32)
