"""The float32 attention kernels (`ssl4gie_tpu_torch/csrc/attention_f32.cuh`)
and the Dh-80 tile layout of the bf16 core (`csrc/wgmma.cuh:Swz<80>`),
emulated in torch on the CPU: the CUDA kernels run only on the card (the
`gpu`-marked tests of `test_torch_kernels.py` and `chip_smoke.py`).

The f32 emulation follows the kernels' index maps and tile loops: a block
of 128 threads on 64 rows, thread (rg, cg) on rows r0 + 2 i (r0 = 16 (rg /
2) + rg % 2) against a tile's rows cg + 16 j, the product's second operand
read back from the half-warp's slots; keys in tiles of 64 with the loop
stopping at the last tile that holds a valid key, the online softmax in
the log2 domain, the log-sum-exp in natural log; the backward as the dq
kernel (over key tiles) then the dk/dv kernel (over query tiles), P and dS
in float32. It is held to the plain versions at the card checks' float32
limits (outputs 1e-5, gradients 1e-4 of the largest value; lse 2^-16)."""

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

ROWS = 64                  # csrc/attention_f32.cuh: kF32Rows
THREADS = 128              # kF32Threads
LOG2E = 1.4426950408889634
F32_OUT, F32_GRAD, LSE_TOL = 1e-5, 1e-4, 2.0 ** -16


def thread_rows(rg: int) -> list[int]:
    """The block rows thread group rg (tid / 16) owns: r0 + 2 i."""
    r0 = (rg >> 1) * 16 + (rg & 1)
    return [r0 + 2 * i for i in range(8)]


def test_thread_and_slot_maps_cover_the_block():
    """Every row of a block is owned by one half-warp, and the slots
    8 rg + i (each half-warp's own columns) are a bijection onto 0..63;
    a half-warp's two groups (rg, rg + 1 in one warp) own neighbouring
    rows, which a padded stride of D + 4 floats puts on other banks."""
    rows = [r for rg in range(THREADS // 16) for r in thread_rows(rg)]
    assert sorted(rows) == list(range(ROWS))
    slots = [8 * rg + i for rg in range(8) for i in range(8)]
    assert sorted(slots) == list(range(ROWS))
    for d in (32, 64, 80):
        ld = d + 4
        for rg in range(0, 8, 2):
            for a, b in zip(thread_rows(rg), thread_rows(rg + 1)):
                assert b == a + 1
                assert (a * ld // 4) % 8 != (b * ld // 4) % 8  # 16 B banks


def f32_fwd(q, k, v, scale: float, n_valid=None):
    """q, k, v (S, N, D) float32 -> (o (S, N, D), lse (S, N)), by the f32
    forward's blocks, thread tiles and key tiles."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    sl2 = np.float32(scale * LOG2E)
    o = torch.zeros((S, N, D))
    lse = torch.zeros((S, N))
    for q0 in range(0, N, ROWS):
        qb = torch.zeros((S, ROWS, D))          # rows >= N read zeros
        qb[:, :min(ROWS, N - q0)] = q[:, q0:q0 + ROWS]
        m = torch.full((S, ROWS), -torch.inf)
        l = torch.zeros((S, ROWS))
        acc = torch.zeros((S, ROWS, D))
        for t0 in range(0, n, ROWS):
            kt = torch.zeros((S, ROWS, D))
            vt = torch.zeros((S, ROWS, D))
            kt[:, :min(ROWS, n - t0)] = k[:, t0:min(t0 + ROWS, n)]
            vt[:, :min(ROWS, n - t0)] = v[:, t0:min(t0 + ROWS, n)]
            slots = torch.zeros((S, ROWS, ROWS))   # [key][slot]
            for rg in range(8):
                rows = thread_rows(rg)
                for cg in range(16):
                    keys = [cg + 16 * j for j in range(4)]
                    s = qb[:, rows] @ kt[:, keys].transpose(1, 2)  # (S, 8, 4)
                    valid = torch.tensor([t0 + kk < n for kk in keys])
                    s = torch.where(valid, s, -torch.inf)
                    slots[:, keys, 8 * rg:8 * rg + 8] = s.transpose(1, 2)
            # the half-warp's reductions over its 16 lanes: whole rows
            srow = torch.zeros((S, ROWS, ROWS))
            for rg in range(8):
                srow[:, thread_rows(rg)] = slots[:, :, 8 * rg:8 * rg + 8] \
                    .transpose(1, 2)
            mx = torch.maximum(m, srow.amax(-1))
            alpha = torch.exp2((m - mx) * sl2)
            p = torch.exp2((srow.double() * float(sl2)
                            - (mx * sl2)[..., None].double()).float())
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vt
            m = mx
        live = min(ROWS, N - q0)
        o[:, q0:q0 + live] = (acc / l[..., None])[:, :live]
        lse[:, q0:q0 + live] = (m * scale + torch.log(l))[:, :live]
    return o, lse


def f32_bwd(q, k, v, o, lse, do, scale: float, n_valid=None):
    """The f32 backward's two kernels: dq over key tiles (delta = rowsum(dO
    * O) in its prologue), then dk, dv over query tiles; P and dS in
    float32, masked keys and rows >= N at p = 0."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    sl2 = np.float32(scale * LOG2E)
    pad = lambda x, rows: torch.cat(
        [x, torch.zeros((S, rows - x.shape[1]) + x.shape[2:])], 1)
    nt = -(-N // ROWS) * ROWS
    qp, kp, vp, dop = (pad(x, nt) for x in (q, k, v, do))
    kp[:, n:] = 0
    vp[:, n:] = 0
    delta = pad((do * o).sum(-1), nt)
    nl = pad(-lse * LOG2E, nt)
    nl[:, N:] = -torch.inf
    dq = torch.zeros((S, nt, D))
    for q0 in range(0, N, ROWS):
        rq = slice(q0, q0 + ROWS)
        for t0 in range(0, n, ROWS):
            rk = slice(t0, t0 + ROWS)
            s = qp[:, rq] @ kp[:, rk].transpose(1, 2)
            dp = dop[:, rq] @ vp[:, rk].transpose(1, 2)
            keys = torch.arange(t0, t0 + ROWS)
            s = torch.where(keys < n, s, -torch.inf)
            p = torch.exp2((s.double() * float(sl2)
                            + nl[:, rq, None].double()).float())
            dq[:, rq] += (p * (dp - delta[:, rq, None])) @ kp[:, rk]
    dk = torch.zeros((S, nt, D))
    dv = torch.zeros((S, nt, D))
    for k0 in range(0, N, ROWS):
        rk = slice(k0, k0 + ROWS)
        if k0 >= n:                       # every key masked: streams nothing
            continue
        for t0 in range(0, N, ROWS):
            rq = slice(t0, t0 + ROWS)
            st = kp[:, rk] @ qp[:, rq].transpose(1, 2)
            dpt = vp[:, rk] @ dop[:, rq].transpose(1, 2)
            keys = torch.arange(k0, k0 + ROWS)[:, None]
            st = torch.where(keys < n, st, -torch.inf)
            pt = torch.exp2((st.double() * float(sl2)
                             + nl[:, None, rq].double()).float())
            dst = pt * (dpt - delta[:, None, rq])
            dv[:, rk] += pt @ dop[:, rq]
            dk[:, rk] += dst @ qp[:, rq]
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
