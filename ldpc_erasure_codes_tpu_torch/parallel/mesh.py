"""Rank meshes and the sharded Monte-Carlo step.

Counterpart of ``ldpc_erasure_codes_tpu/parallel/mesh.py`` over
``torch.distributed``: one process per device, a ``DeviceMesh`` over the
ranks in place of JAX's mesh of devices.

* :func:`shard_sim_step` is ``shard_map`` with ``psum`` (:52-81): every rank
  of the data axis runs the per-shard simulation step on its own random
  streams (its data coordinate is the step's ``shard``; shard 0 draws the
  unsharded step's streams), and the statistics are summed with one
  ``all_reduce`` over the data axis's group, so every rank holds the same
  result.
* :func:`shard_batch` is ``batch_sharding`` (:84-91): this rank's slice of a
  (B, n[, W]) tensor, the batch split over the data axis and, when the mesh
  has a lane axis, the word axis over it.

Multi-host: launch one process per card (``torchrun``), call
:func:`.multihost.initialize`, then build the mesh; nothing else changes.
The all-reduce payload is one int64 vector of (9 + max_iters) counters per
step, so no per-frame data crosses the interconnect.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXIS = "data"  # codeword-batch axis (DP analog)
LANE_AXIS = "lane"  # packed symbol-word axis (the reference's bit-plane axis)


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = (BATCH_AXIS,),
    device_type: str | None = None,
) -> DeviceMesh:
    """A 1-D or 2-D mesh of the given shape over the first prod(shape)
    ranks, row-major. Every rank must call it (it creates the axes'
    process groups); ranks outside the mesh get ``get_coordinate() is
    None``. ``device_type`` defaults to the process group's: ``"cuda"``
    under NCCL, ``"cpu"`` under gloo."""
    if len(shape) != len(axis_names) or not 1 <= len(shape) <= 2:
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} must be 1-D "
                         "or 2-D and match")
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks, have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n, dtype=torch.int32).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def default_mesh() -> DeviceMesh:
    """1-D data-parallel mesh over all ranks."""
    return make_mesh((dist.get_world_size(),), (BATCH_AXIS,))


def coordinate(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's index along ``axis_name``; raises for a rank outside
    the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return coord[mesh.mesh_dim_names.index(axis_name)]


def all_reduce_stats(stats, group):
    """Every field of a ``SimStats`` summed over ``group`` with one
    ``all_reduce`` of the concatenated int64 counters (bool cannot be
    reduced; NCCL reduces tensors on the card, gloo on the CPU, where the
    step left them)."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in stats])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return type(stats).from_flat(flat)


def shard_sim_step(
    step_fn: Callable,
    mesh: DeviceMesh,
    axis_name: str = BATCH_AXIS,
) -> Callable:
    """Lift a per-shard sim step ``step(call, per, shard=0) -> SimStats``
    onto the mesh: each rank runs its shard (its coordinate along
    ``axis_name``) and the statistics are summed over that axis, so every
    rank returns the same totals. Ranks that differ only along another axis
    run the same shard, as JAX's replicated ``shard_map`` does."""
    group = mesh.get_group(axis_name)
    shard = coordinate(mesh, axis_name)

    @functools.wraps(step_fn)
    def run(call: int, per):
        return all_reduce_stats(step_fn(call, per, shard=shard), group)

    return run


def shard_batch(t: torch.Tensor, mesh: DeviceMesh, lane_axis_dim: int | None = None
                ) -> torch.Tensor:
    """This rank's block of a (B, n[, W]) tensor: the batch axis split over
    ``BATCH_AXIS`` and, when the mesh has ``LANE_AXIS`` and
    ``lane_axis_dim`` is given, that axis split over ``LANE_AXIS``. The
    split axes must divide evenly."""
    names = mesh.mesh_dim_names
    cuts = [(0, BATCH_AXIS)]
    if LANE_AXIS in names and lane_axis_dim is not None:
        cuts.append((lane_axis_dim, LANE_AXIS))
    for dim, axis in cuts:
        parts = mesh.size(names.index(axis))
        if t.shape[dim] % parts:
            raise ValueError(f"axis {dim} of {tuple(t.shape)} does not split into {parts}")
        t = t.chunk(parts, dim=dim)[coordinate(mesh, axis)]
    return t.contiguous()
