"""Multi-process execution over ``torch.distributed``.

Counterpart of ``ldpc_erasure_codes_tpu/parallel/multihost.py`` (:30-48).
The workload is embarrassingly parallel per codeword and the inputs are
generated on the device, so running on many cards reduces to: one process
per card, the code tables replicated, the random streams split by rank, and
the small statistics vectors summed with ``all_reduce``.

Usage in each process (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):

    from ldpc_erasure_codes_tpu_torch.parallel import multihost, shard_sim_step
    multihost.initialize()            # NCCL on the card; device="cpu": gloo
    mesh = multihost.global_mesh()    # 1-D data mesh over every rank
    step = shard_sim_step(make_sim_step(code, cfg, device=multihost.device()), mesh)
    stats = step(0, per)              # the same summed SimStats on every rank
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ldpc_erasure_codes_tpu_torch.parallel.mesh import BATCH_AXIS, make_mesh


def initialize(
    device: str = "cuda",
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> None:
    """``torch.distributed.init_process_group`` for this package: NCCL with
    one card per process for ``device="cuda"`` (the local card, ``LOCAL_RANK``
    or the rank modulo the cards, becomes the current device first), gloo
    for ``device="cpu"``.

    ``world_size`` and ``rank`` default to the launcher's ``WORLD_SIZE`` and
    ``RANK`` (1 and 0 without a launcher); ``init_method`` (``tcp://host:port``
    or ``file://path``, as JAX's ``coordinator_address``) defaults to the
    launcher's ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). A single process
    without either gets an in-memory store: no port, no file.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    kwargs = dict(world_size=world_size, rank=rank)
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif "MASTER_ADDR" in os.environ:
        kwargs["init_method"] = "env://"
    elif world_size == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError("world_size > 1 needs an init_method or the launcher's MASTER_ADDR "
                         "and MASTER_PORT")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local), **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)


def shutdown() -> None:
    """Destroy the process group (after the last collective)."""
    dist.destroy_process_group()


def device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh():
    """1-D data-parallel mesh spanning every rank of every process."""
    return make_mesh((dist.get_world_size(),), (BATCH_AXIS,))


def process_info() -> dict:
    """JAX's ``process_info`` keys; one device per process."""
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
