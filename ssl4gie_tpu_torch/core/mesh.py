"""Device meshes over the process group (port of `ssl4gie_tpu/core/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over every device and lets
GSPMD shard the batch over its "data" axis. Here each process drives one
GPU: `make_mesh` lays the processes out as a
`torch.distributed.device_mesh.DeviceMesh`, ("data",) by default, whose
groups the placements of `parallel/tp.py` reduce over, and each rank
holds its slice of the global batch (`shard_batch`,
`parallel/distributed.py:local_rows`). A single process has no mesh
(None), and every helper treats it as a data axis of one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ssl4gie_tpu_torch.parallel import distributed as dist_lib


def maybe_init_distributed(device="cuda") -> bool:
    """Open the process group if the launcher calls for one; both CLIs
    call it first (alias of `parallel.distributed.initialize`)."""
    return dist_lib.initialize(device)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data",), device="cuda"):
    """A DeviceMesh of `shape` (default: every process on the first axis)
    named `axes`, over the device type of `device`; None for a single
    process."""
    n = dist_lib.process_count()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} with axes {tuple(axes)} does "
                         f"not lay out {n} processes")
    if not dist_lib.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str = "data") -> int:
    """The size of `mesh`'s axis `axis` (1 without a mesh or that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str = "data") -> int:
    """This process's index along `mesh`'s axis `axis`."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_shard(mesh, axis: str = "data") -> tuple[int, int]:
    """(this process's index, the size) along `mesh`'s axis `axis`: the
    `shard` of a Loader."""
    return axis_index(mesh, axis), axis_size(mesh, axis)


def local_batch_size(global_batch: int, mesh, axis: str = "data") -> int:
    n = axis_size(mesh, axis)
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel "
            f"size {n} (the reference asserts the same divisibility, "
            "train_classification.py:420)")
    return global_batch // n


def shard_batch(batch, mesh=None, axis: str = "data"):
    """This rank's contiguous slice along dim 0 of every tensor or array
    of `batch` (a dict, list or tuple of them), the global batch split
    over `mesh`'s axis `axis` (the data group when no mesh is given)."""
    shard = dist_lib.data_shard() if mesh is None else axis_shard(mesh, axis)
    leaves = [x for x in (batch.values() if isinstance(batch, dict)
                          else batch) if hasattr(x, "shape")]
    n_global = leaves[0].shape[0]
    return dist_lib.take_rows(batch, dist_lib.local_rows(n_global, 1, shard),
                              n_global)
