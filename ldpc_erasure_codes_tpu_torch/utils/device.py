"""The CUDA device: selection, its memory sizes and the card's identity for
measurements.

Counterpart of ``ldpc_erasure_codes_tpu/utils/device.py`` (:1-90).
``hbm_bytes`` is JAX's (:77-90), read from the card's properties;
``smem_bytes`` stands where JAX's ``vmem_bytes`` (:47) does, the shared
memory one block may opt into; ``l2_bytes`` is the card's L2, the on-chip
store the TPU's VMEM budget stood for. JAX's ``peel_vmem_budget`` and
``kernel_vmem_limit`` size the TPU kernels' VMEM tiles from Python; the
port's kernels ask the card from C++ instead (for example
``ops/elim.py::fits_shared_memory`` over ``ldpc_elim_fits_smem``), and the
slab routes size their blocks against the opt-in limit ``_build.SMEM_LIMIT``
that every sm_90 card shares, so this module has no Python budget for them.
"""

from __future__ import annotations

import subprocess

import torch


def cuda_device() -> torch.device:
    """The current CUDA device (the first card, unless a process of a
    multi-card run set its own); raises where there is none (a measurement
    path never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def _properties(device: torch.device | str | None):
    device = cuda_device() if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{device} is not a CUDA device")
    return torch.cuda.get_device_properties(device)


def hbm_bytes(device: torch.device | str | None = None) -> int:
    """Device memory of the card ``device`` (default: the current card), in
    bytes (``total_memory``); raises where there is no card."""
    return int(_properties(device).total_memory)


def smem_bytes(device: torch.device | str | None = None) -> int:
    """Shared memory one block may opt into on ``device``, in bytes
    (``sharedMemPerBlockOptin``: 227 KB on an H100); raises where there is
    no card."""
    return int(_properties(device).shared_memory_per_block_optin)


def l2_bytes(device: torch.device | str | None = None) -> int:
    """L2 cache of ``device``, in bytes (50 MB on an H100 SXM); raises where
    there is no card."""
    return int(_properties(device).L2_cache_size)


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
