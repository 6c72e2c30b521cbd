"""PyTorch port of ssl4gie_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout: `models/vit.py` here is the counterpart of
`ssl4gie_tpu/models/vit.py`. Every Pallas kernel on a ported path has a
hand-written CUDA kernel under `csrc/`, built at first use
(`kernels/_build.py`). This package imports torch and never jax.
"""
