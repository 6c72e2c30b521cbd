"""The float32 attention kernels (`ssl4gie_tpu_torch/csrc/attention_tf32.cuh`,
the 3xTF32 forward and backward) and the Dh-80 tile layout of the bf16 core
(`csrc/wgmma.cuh:Swz<80>`), emulated in torch on the CPU: the CUDA kernels
run only on the card (the `gpu`-marked tests of `test_torch_kernels.py` and
`chip_smoke.py`).

The emulations follow the kernels' arithmetic: every operand split into
TF32 hi and lo parts (round to nearest, ties away, on the low 13 bits), each
product issued a k-step of 8 at a time as lo.hi, hi.lo, hi.hi into an f32
accumulator. The forward runs query blocks of 64 G rows against the
streamed key tiles (64 rows, 32 at Dh 80) up to the last tile that holds a
valid key, S = Q.K^T and each tile's P.V so (the latter into a partial
that is added to the output), the online softmax in the log2 domain, the
log-sum-exp in natural log. The backward runs the dq kernel
(over key tiles) then the dk/dv kernel (over query tiles), P and dS in
float32. Their register and shared-memory maps (the TF32 A fragment, the
transposed tiles' permuted rows, the panels' swizzle, the split pass's
lanes) are checked apart. Both are held to the plain versions at the card
checks' float32 limits (outputs 1e-5, gradients 1e-4 of the largest
value; lse 2^-16), and the forward to the JAX package's Pallas forwards."""

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
F32_OUT, F32_GRAD, LSE_TOL = 1e-5, 1e-4, 2.0 ** -16


def rna_tf32(x):
    """cvt.rna.tf32.f32 on float32 bits: the low 13 bits rounded to nearest,
    ties away from zero (adding half a TF32 ulp to the magnitude), then
    cleared."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """x = hi + lo, both TF32, as the kernels split every operand."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def tf32_product(acc, a, b, passes: int = 3):
    """acc + a @ b, a (S, M, K) and b (S, K, N) float32, in k-steps of 8 as
    the kernels issue them: lo_a.hi_b, hi_a.lo_b, hi_a.hi_b into the f32
    accumulator (passes=1: hi_a.hi_b alone, one TF32 product)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            acc = acc + al[..., ks] @ bh[:, ks]
            acc = acc + ah[..., ks] @ bl[:, ks]
        acc = acc + ah[..., ks] @ bh[:, ks]
    return acc


def tile_rows(d: int) -> int:
    """csrc/attention_tf32.cuh: kTf32Rows, the streamed tile's rows."""
    return 32 if d == 80 else 64


def fwd_groups(d: int) -> int:
    """csrc/attention_tf32.cuh: kFwdGroups, the multiplying warpgroups of a
    forward block, each on 64 query rows."""
    return 1 if d == 80 else 2


def f32_fwd(q, k, v, scale: float, n_valid=None, passes: int = 3):
    """q, k, v (S, N, D) float32 -> (o (S, N, D), lse (S, N)), by the 3xTF32
    forward: query blocks of 64 G rows (rows >= N read zeros and are not
    stored; a block's rows are independent of the other blocks', so all run
    at once), keys in the streamed tiles (keys >= n_valid read zeros and
    score -inf) up to the last tile that holds a valid key, S = Q.K^T and
    each tile's P.V through tf32_product, the latter into a zeroed partial
    added to the output as o * alpha + part, the online softmax in the log2
    domain, the output times 1 / (row sum) at the end, the lse in natural
    log."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    T, rows = tile_rows(D), 64 * fwd_groups(D)
    nq, nk = -(-N // rows) * rows, -(-n // T) * T
    sl2 = np.float32(scale * LOG2E)
    qp = torch.zeros((S, nq, D))
    qp[:, :N] = q
    kp, vp = torch.zeros((S, nk, D)), torch.zeros((S, nk, D))
    kp[:, :n], vp[:, :n] = k[:, :n], v[:, :n]
    m = torch.full((S, nq), -torch.inf)
    l = torch.zeros((S, nq))
    acc = torch.zeros((S, nq, D))
    for t0 in range(0, n, T):
        kt, vt = kp[:, t0:t0 + T], vp[:, t0:t0 + T]
        s = tf32_product(torch.zeros((S, nq, T)), qp, kt.transpose(1, 2),
                         passes)
        s = torch.where(torch.arange(t0, t0 + T) < n, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * sl2)
        p = torch.exp2((s.double() * float(sl2)
                        - (mx * sl2)[..., None].double()).float())
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + tf32_product(torch.zeros_like(acc),
                                                    p, vt, passes)
        m = mx
    o = acc * (1 / l)[..., None]
    return o[:, :N], (m * scale + torch.log(l))[:, :N]


def f32_bwd(q, k, v, o, lse, do, scale: float, n_valid=None,
            passes: int = 3):
    """The 3xTF32 backward's two kernels: dq over key tiles (delta =
    rowsum(dO * O) in its prologue), then dk, dv over query tiles, every
    product split and issued as tf32_product does; P and dS in float32,
    masked keys and rows >= N at p = 0. A block's 64 rows are independent,
    so every block of a kernel runs at once; the tiles it streams run in
    order, as the accumulation does."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    T = tile_rows(D)
    sl2 = np.float32(scale * LOG2E)
    pad = lambda x, rows: torch.cat(
        [x, torch.zeros((S, rows - x.shape[1]) + x.shape[2:])], 1)
    nt = -(-N // 64) * 64
    qp, kp, vp, dop = (pad(x, nt) for x in (q, k, v, do))
    kp[:, n:] = 0
    vp[:, n:] = 0
    delta = pad((do * o).sum(-1), nt)
    nl = pad(-lse * LOG2E, nt)
    nl[:, N:] = -torch.inf
    dq = torch.zeros((S, nt, D))
    for t0 in range(0, n, T):
        rk = slice(t0, t0 + T)
        kt, vt = kp[:, rk], vp[:, rk]
        s = tf32_product(torch.zeros((S, nt, kt.shape[1])), qp,
                         kt.transpose(1, 2), passes)
        dp = tf32_product(torch.zeros_like(s), dop, vt.transpose(1, 2),
                          passes)
        keys = torch.arange(t0, t0 + kt.shape[1])
        s = torch.where(keys < n, s, -torch.inf)
        p = torch.exp2((s.double() * float(sl2)
                        + nl[..., None].double()).float())
        dq = tf32_product(dq, p * (dp - delta[..., None]), kt, passes)
    dk = torch.zeros((S, nt, D))
    dv = torch.zeros((S, nt, D))
    valid = (torch.arange(nt) < n)[:, None]
    for t0 in range(0, N, T):
        rq = slice(t0, t0 + T)
        qt, dot = qp[:, rq], dop[:, rq]
        st = tf32_product(torch.zeros((S, nt, qt.shape[1])), kp,
                          qt.transpose(1, 2), passes)
        dpt = tf32_product(torch.zeros_like(st), vp, dot.transpose(1, 2),
                           passes)
        st = torch.where(valid, st, -torch.inf)
        pt = torch.exp2((st.double() * float(sl2)
                         + nl[:, None, rq].double()).float())
        dst = pt * (dpt - delta[:, None, rq])
        dv = tf32_product(dv, pt, dot, passes)
        dk = tf32_product(dk, dst, qt, passes)
    return dq[:, :N] * scale, dk[:, :N] * scale, dv[:, :N]


def _close(got, ref, tol):
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("n,d,n_valid", [
    (197, 64, None),          # ViT-B: a 5-row last query tile and key tile
    (180, 80, None),          # ViT-H at mask 0.3
    (197, 32, None),          # the MAE decoder
    (256, 64, 200),           # flash: a partial last key tile
    (256, 64, 3),             # flash: dk/dv blocks whose keys are all masked
])
def test_f32_tiles_match_plain(n, d, n_valid):
    """Forward and backward of the emulated kernels against the plain
    versions (the flash layout's, which masks keys >= n_valid)."""
    rng = np.random.default_rng(n + d)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (2, n, d)).astype(
        np.float32)) for _ in range(4))
    scale = d ** -0.5
    o, lse = f32_fwd(q, k, v, scale, n_valid)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, n_valid)
    _close(o, o_p, F32_OUT)
    assert bool(((lse - lse_p).abs() <= LSE_TOL * (lse_p.abs()
                                                   + lse_p.abs().max())).all())
    for got, ref in zip(f32_bwd(q, k, v, o, lse, do, scale, n_valid),
                        fa.flash_attention_bwd_plain(q, k, v, do, scale,
                                                     n_valid)):
        _close(got, ref, F32_GRAD)


def test_f32_packed_layout_matches_the_dense_plain():
    """The packed-QKV layout (head h at columns h * D of q, k and v) through
    the emulation, against the dense kernel's plain version at Dh 80."""
    heads, d, n = 2, 80, 180
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (1, n, 3 * heads * d)).astype(
        np.float32))
    t = qkv.reshape(1, n, 3, heads, d).permute(2, 0, 3, 1, 4)[:, 0]
    o, lse = f32_fwd(t[0], t[1], t[2], d ** -0.5)
    o_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, d ** -0.5)
    _close(o.transpose(0, 1).reshape(1, n, heads * d), o_p, F32_OUT)
    _close(lse[None], lse_p, LSE_TOL)


def _ref64(q, k, v, do, scale, n_valid=None):
    """dq, dk, dv of softmax attention in float64, keys >= n_valid masked."""
    q, k, v = (x.double().requires_grad_(True) for x in (q, k, v))
    s = q @ k.transpose(1, 2) * scale
    if n_valid is not None:
        s = s.masked_fill(torch.arange(s.shape[-1]) >= n_valid, -torch.inf)
    o = torch.softmax(s, -1) @ v
    return torch.autograd.grad(o, (q, k, v), do.double())


@pytest.fixture(scope="module")
def flash_4096():
    """One sequence at the flash path's N = 4096, Dh 64: its inputs, the
    plain forward's o and lse, and the float64 gradients."""
    rng = np.random.default_rng(4096)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (1, 4096, 64)).astype(
        np.float32)) for _ in range(4))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, 0.125)
    return (q, k, v, o, lse, do), _ref64(q, k, v, do, 0.125)


def test_tf32_bwd_at_the_flash_length(flash_4096):
    """The longest contraction the paths give the backward: 4096 queries
    summed into dK and dV, 4096 keys into dQ, at the gradient limit."""
    (q, k, v, o, lse, do), _ = flash_4096
    for got, ref in zip(f32_bwd(q, k, v, o, lse, do, 0.125),
                        fa.flash_attention_bwd_plain(q, k, v, do, 0.125)):
        _close(got, ref, F32_GRAD)


def test_one_tf32_pass_is_a_different_function(flash_4096):
    """At N = 4096, one TF32 product (hi.hi alone) is at least 100x further
    from the float64 gradients than the three of the 3xTF32 split: the
    split is what keeps float32's precision."""
    (q, k, v, o, lse, do), ref = flash_4096
    err = lambda passes: max(
        ((g.double() - r).abs().max() / r.abs().max()).item()
        for g, r in zip(f32_bwd(q, k, v, o, lse, do, 0.125, passes=passes),
                        ref))
    three, one = err(3), err(1)
    assert three < F32_GRAD and one >= 100 * three, (three, one)


@pytest.fixture(scope="module")
def flash_4096_o64(flash_4096):
    """The float64 attention output on flash_4096's inputs."""
    (q, k, v, *_), _ = flash_4096
    s = q.double() @ k.double().transpose(1, 2) * 0.125
    return torch.softmax(s, -1) @ v.double()


def test_one_tf32_pass_is_a_different_function_forward(flash_4096,
                                                       flash_4096_o64):
    """The forward at N = 4096: one TF32 pass a product (hi.hi alone, in
    S = Q.K^T and in O += P.V) is at least 100x further from the float64
    output than the three of the 3xTF32 split, which stays within the
    output limit."""
    (q, k, v, *_), _ = flash_4096
    ref = flash_4096_o64
    err = lambda passes: ((f32_fwd(q, k, v, 0.125, passes=passes)[0].double()
                           - ref).abs().max() / ref.abs().max()).item()
    three, one = err(3), err(1)
    assert three < F32_OUT and one >= 100 * three, (three, one)


def _pallas_fwd(layout: str, rng):
    """(inputs, the Pallas forward's output, its lse or None) in float32, the
    JAX kernels in interpret mode: `fused_qkv_attention` at N = 197 (2 heads
    of 64), `windowed_flash_attention` on a 32 x 32 grid in 16 x 16 windows
    (2 heads of 64), the flash forward at N = 256 with 200 valid keys."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels import dense_attention as jda
    from ssl4gie_tpu.kernels import flash_attention as jfa
    from ssl4gie_tpu.kernels import window_attention as jwa
    heads, d = 2, 64
    with pltpu.force_tpu_interpret_mode():
        if layout == "flash":
            x = rng.normal(0, 1, (3, heads, 256, d)).astype(np.float32)
            o, res = jfa._flash_fwd(*(jnp.asarray(t) for t in x), d ** -0.5,
                                    200)
            return x, np.array(o), np.array(res[4])[:, 0]
        if layout == "dense":
            x = rng.normal(0, 1, (1, 197, 3 * heads * d)).astype(np.float32)
            o = jda.fused_qkv_attention(jnp.asarray(x), heads, d ** -0.5)
        else:
            x = rng.normal(0, 1, (1, 32, 32, 3 * heads * d)).astype(
                np.float32)
            o = jwa.windowed_flash_attention(jnp.asarray(x), heads, 16,
                                             d ** -0.5)
    return x, np.array(o), None


@pytest.mark.parametrize("layout", ["dense", "window", "flash"])
def test_f32_fwd_matches_the_pallas_forwards(layout):
    """The emulated 3xTF32 forward against the JAX package's Pallas forwards
    run at float32 (dense_attention.py:146, window_attention.py:97,
    flash_attention.py:146), each layout cut into the kernel's sequences and
    heads: outputs within 1e-5 of the largest, the flash lse within 2^-16."""
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    heads, d = 2, 64
    x, ref, lse_ref = _pallas_fwd(layout, np.random.default_rng(19))
    x = torch.from_numpy(x)
    if layout == "flash":
        o, lse = f32_fwd(x[0], x[1], x[2], d ** -0.5, 200)
        _close(lse, torch.from_numpy(lse_ref), LSE_TOL)
    else:
        seqs = x if layout == "dense" else wa.partition(x, 16)
        S, n = seqs.shape[:2]
        t = seqs.reshape(S, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        o, _ = f32_fwd(*(y.reshape(S * heads, n, d) for y in t), d ** -0.5)
        o = o.reshape(S, heads, n, d).transpose(1, 2).reshape(S, n, -1)
        if layout == "window":
            o = wa.merge(o, 1, 32, 32, 16)
    _close(o, torch.from_numpy(ref), F32_OUT)


# ------------------------------------------ the 3xTF32 backward's maps
def tf32_pos(i: int) -> int:
    """csrc/attention_tf32.cuh:tf32_pos, the k position of row i of 8."""
    return (i >> 1) + ((i & 1) << 2)


def pan_offset(rows: int, r: int, c: int) -> int:
    """csrc/attention_tf32.cuh:F32Pan<rows>::offset, in bytes."""
    return (c >> 3) * rows * 32 + r * 32 + ((((c >> 2) ^ (r >> 2)) & 1) << 4) \
        + (c & 3) * 4


def test_tf32_fragment_map_multiplies_the_permuted_tile():
    """The accumulator of P or dS goes into the TF32 register A operand
    unchanged (`tf32_frags`): by CUTLASS's ALayout_64x8 thread t of the
    warpgroup holds A (16 w + g, t % 4), (+ 8, t % 4), (16 w + g, t % 4 +
    4), (+ 8, + 4) (g = lane / 4), so A's k position p is the
    accumulator's column 2p (p < 4) or 2(p - 4) + 1, and the transposed
    tile that the split pass writes with rows in tf32_pos order makes the
    hardware's A . B the product over the right keys."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8))           # one k-step of the accumulator
    b = rng.normal(size=(8, 5))            # the 8 source rows of the operand
    a_hw = np.zeros((64, 8))
    for tid in range(128):
        w, lane = tid // 32, tid % 32
        g, t = lane // 4, lane % 4
        acc = {0: (16 * w + g, 2 * t), 1: (16 * w + g, 2 * t + 1),
               2: (16 * w + g + 8, 2 * t), 3: (16 * w + g + 8, 2 * t + 1)}
        frag = [acc[0], acc[2], acc[1], acc[3]]      # tf32_frags' order
        place = [(16 * w + g, t), (16 * w + g + 8, t), (16 * w + g, t + 4),
                 (16 * w + g + 8, t + 4)]            # ALayout_64x8
        for src, dst in zip(frag, place):
            a_hw[dst] = x[src]
    b_hw = np.zeros_like(b)
    for i in range(8):
        b_hw[tf32_pos(i)] = b[i]
    np.testing.assert_allclose(a_hw @ b_hw, x @ b, rtol=1e-12)


@pytest.mark.parametrize("rows", [32, 64, 80])
def test_f32_panel_layout(rows):
    """F32Pan<rows> places a tile of 80 columns bijectively on its bytes,
    each panel the hardware's 32-byte swizzle of 8-column rows (so the
    descriptor of mode 3, 8-row groups 256 bytes apart, reads what offset
    wrote), a k-step one panel, and every panel 256-byte aligned."""
    offs = [pan_offset(rows, r, c) for r in range(rows) for c in range(80)]
    assert sorted(offs) == list(range(0, rows * 80 * 4, 4))
    for r in range(rows):
        for c in range(80):
            panel = (c >> 3) * rows * 32
            assert pan_offset(rows, r, c) == panel + hardware_swizzle(
                r * 32 + (c & 7) * 4, 32)
    assert rows * 32 % 256 == 0


@pytest.mark.parametrize("r_rows,c_cols", [(64, 32), (64, 64), (64, 80),
                                           (32, 80)])
def test_split_pass_lanes(r_rows, c_cols):
    """split_tile: the block's 8 warps (kTf32Threads = 256) take units of
    8 rows x 4 chunks in turn, which cover every float4 of the tile once,
    and each transposed store (lane with chunk cq storing column (e + cq) %
    4 of it) puts a warp's 32 lanes on 32 banks; each quarter-warp's float4
    accesses are conflict-free."""
    units, warps = r_rows * c_cols // 128, 8
    seen = set()
    for i in range(-(-units // warps)):
        for warp in range(warps):
            u = warp + warps * i
            if u >= units:
                break
            lanes = []
            for lane in range(32):
                cq = lane >> 3
                r = (u % (r_rows // 8)) * 8 + (lane & 7)
                c = (u // (r_rows // 8)) * 16 + 4 * cq
                lanes.append((r, c, cq))
                seen.add((r, c))
            for e in range(4):
                banks = {(pan_offset(c_cols, c + ((e + cq) & 3),
                                     (r & ~7) + tf32_pos(r & 7)) // 4) % 32
                         for r, c, cq in lanes}
                assert len(banks) == 32
            for qw in range(4):
                words = {pan_offset(r_rows, r, c) // 4 % 32 // 4
                         for r, c, _ in lanes[8 * qw:8 * qw + 8]}
                assert len(words) == 8
    assert seen == {(r, c) for r in range(r_rows)
                    for c in range(0, c_cols, 4)}


@pytest.mark.parametrize("d", [32, 64, 80])
def test_tf32_bwd_shared_memory_fits(d):
    """dq_smem_tf32 and dkv_smem_tf32 (their tiles, the dk/dv kernel's
    lse and delta stages, 1 KiB for alignment) fit a block's 227 KiB."""
    t, x = tile_rows(d), 64 * d * 4
    dq = 4 * x + 8 * t * d * 4 + 1024
    dkv = 4 * x + 10 * t * d * 4 + 2 * 2 * t * 4 + 1024
    assert max(dq, dkv) <= 232448, (dq, dkv)


@pytest.mark.parametrize("d", [32, 64, 80])
def test_tf32_fwd_shared_memory_fits(d):
    """fwd_smem_tf32 at kFwdGroups (Q hi and lo of each multiplying
    warpgroup; K lo, V^T hi and lo; two stages of K and V; 1 KiB for
    alignment) fits a block's 227 KiB, with the block's two warpgroups."""
    g, t = fwd_groups(d), tile_rows(d)
    assert 1 <= g <= 2
    assert (2 * 64 * g + 7 * t) * d * 4 + 1024 <= 232448


# ------------------------------------------------- Swz<80>, the bf16 core
def swz80_offset(r: int, c: int) -> int:
    """csrc/wgmma.cuh:Swz<80>::offset: the byte of 16-byte chunk c of row r
    of a 64-row tile: part A (chunks 0-7) the 128-byte swizzle, part B
    (chunks 8-9) the 32-byte swizzle, 8 KiB on."""
    if c < 8:
        return r * 128 + ((c ^ (r & 7)) << 4)
    return 64 * 128 + r * 32 + (((c - 8) ^ ((r >> 2) & 1)) << 4)


def hardware_swizzle(addr: int, mode_bytes: int) -> int:
    """The address a wgmma operand of swizzle `mode_bytes` reads for the
    unswizzled byte address `addr`: bits 4.. XOR bits 7.. (1, 2 or 3 bits
    for the 32-, 64- and 128-byte swizzles)."""
    bits = {32: 1, 64: 2, 128: 3}[mode_bytes]
    mask = (1 << bits) - 1
    return addr ^ (((addr >> 7) & mask) << 4)


def test_swz80_tile_layout():
    """Swz<80> places a 64-row, 10-chunk tile bijectively on its 10 KiB;
    each part is the hardware's swizzle of a plain row-major layout of its
    columns (part A's rows 128 B, part B's 32 B, both parts 1 KiB-aligned
    in a 1 KiB-aligned tile), so the descriptors `desc` (128-byte mode,
    8-row groups 1 KiB apart) and `desc_b` (32-byte mode, 256 B apart) read
    what `offset` wrote; a 16-column k-step or a 16-row MN-major step never
    crosses the parts."""
    offs = [swz80_offset(r, c) for r in range(64) for c in range(10)]
    assert sorted(offs) == list(range(0, 64 * 160, 16))
    for r in range(64):
        for c in range(8):
            assert swz80_offset(r, c) == hardware_swizzle(r * 128 + c * 16,
                                                          128)
        for c in range(2):
            assert swz80_offset(r, 8 + c) == 64 * 128 + hardware_swizzle(
                r * 32 + c * 16, 32)
    # k-steps of 16 columns (2 chunks): chunks 0-7 in four steps, 8-9 in one
    steps = [{(2 * kk) // 8, (2 * kk + 1) // 8} for kk in range(5)]
    assert steps == [{0}, {0}, {0}, {0}, {1}]
    # a tile of Q, K or V is 10 KiB: every tile of the ring, and part B in
    # it, starts 1 KiB-aligned
    assert 64 * 160 % 1024 == 0 and 64 * 128 % 1024 == 0
