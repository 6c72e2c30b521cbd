"""The yardstick's arithmetic: model FLOPs, attention work, the card's peaks.

Pure Python, frozen with the benchmark so that a change to the program
cannot change what its numbers are measured against.

Convention: one multiply-accumulate is 2 FLOP; a training step is 3 times
the forward (each forward GEMM spawns a dx and a dW GEMM of the same cost);
work that a kernel recomputes is not counted. The attention work is what
the mathematics needs: the forward 2 products (Q.K^T, P.V), the backward 4
(dP, dV, dQ, dK), each input read once and each output written once.
"""

from __future__ import annotations

MAC = 2
# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def encoder_forward_flops(n_tokens: int, dim: int, hidden: int, layers: int,
                          heads: int) -> float:
    """Forward FLOPs of `layers` pre-norm transformer blocks over one
    sequence of `n_tokens`: qkv, the two attention products, proj, fc1,
    fc2."""
    dh = dim // heads
    qkv = MAC * n_tokens * dim * 3 * dim
    proj = MAC * n_tokens * dim * dim
    scores = MAC * heads * n_tokens * n_tokens * dh
    mlp = MAC * n_tokens * dim * hidden * 2
    return float(layers * (qkv + proj + 2 * scores + mlp))


def linear_flops(rows: int, d_in: int, d_out: int) -> float:
    return float(MAC * rows * d_in * d_out)


def vit_classifier_forward_flops(img: int, patch: int, dim: int, hidden: int,
                                 layers: int, heads: int,
                                 classes: int) -> float:
    """One image through ViT (cls token + img/patch squared patches) and a
    linear head on the cls token."""
    grid = (img // patch) ** 2
    return (linear_flops(grid, patch * patch * 3, dim)
            + encoder_forward_flops(grid + 1, dim, hidden, layers, heads)
            + linear_flops(1, dim, classes))


def mae_forward_flops(img: int, patch: int, dim: int, hidden: int,
                      layers: int, heads: int, dec_dim: int, dec_hidden: int,
                      dec_layers: int, dec_heads: int,
                      mask_ratio: float) -> float:
    """One image through MAE: the patch projection of every patch, the
    encoder over the kept patches and cls, decoder_embed, the decoder over
    every patch and cls, decoder_pred (`models_mae.py`)."""
    grid = (img // patch) ** 2
    kept = int(grid * (1 - mask_ratio)) + 1
    return (linear_flops(grid, patch * patch * 3, dim)
            + encoder_forward_flops(kept, dim, hidden, layers, heads)
            + linear_flops(kept, dim, dec_dim)
            + encoder_forward_flops(grid + 1, dec_dim, dec_hidden,
                                    dec_layers, dec_heads)
            + linear_flops(grid + 1, dec_dim, patch * patch * 3))


def train_flops(forward_flops: float) -> float:
    """Forward + backward, recompute not counted."""
    return 3.0 * forward_flops


def attention_work(seqs: int, heads: int, n: int, dh: int, backward: bool,
                   itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of softmax attention over `seqs` sequences of `n`
    tokens and `heads` heads of `dh`. Forward: 2 products of 2 n^2 dh a
    head; q, k, v read, o written. Backward: 4 products (dP, dV, dQ, dK);
    q, k, v and dO read, dq, dk, dv written. `itemsize` bytes an element."""
    c = heads * dh
    products = 4 if backward else 2
    flops = products * MAC * seqs * heads * n * n * dh
    elems = seqs * n * ((3 * c + c + 3 * c) if backward else (3 * c + c))
    return float(flops), float(elems * itemsize)


def bound_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_BF16_FLOPS,
                  peak_bytes: float = PEAK_HBM_BYTES) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the peak bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes)
