"""Erasure channel (i.i.d.), on the device.

Counterpart of ``ldpc_erasure_codes_tpu/channel/erasure.py``
(``iid_erasures`` :42-45, ``apply_erasures`` :104). Random numbers come from
an explicit ``torch.Generator``; they differ from ``jax.random``'s stream,
so tests hand both sides the same NumPy mask.

Erasures are out of band: a bool mask plus the invariant that erased value
slots hold zero.
"""

from __future__ import annotations

import torch


def iid_erasures(
    shape: tuple[int, ...],
    per: float,
    *,
    generator: torch.Generator,
    device: torch.device | str,
) -> torch.Tensor:
    """i.i.d. erasure mask, P(erased) = per (``<=`` as the JAX version)."""
    return torch.rand(shape, generator=generator, device=device) <= per


def apply_erasures(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the erased slots. ``values`` is (B, n) or (B, n, W); ``mask``
    is (B, n)."""
    if values.dim() == mask.dim() + 1:
        mask = mask[..., None]
    return values.masked_fill(mask, 0)
