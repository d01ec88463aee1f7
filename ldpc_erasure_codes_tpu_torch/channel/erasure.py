"""Erasure channels, on the device.

Counterpart of ``ldpc_erasure_codes_tpu/channel/erasure.py``:

* ``iid_erasures`` (:42-45), i.i.d. with a real-valued PER;
* ``iid_erasures_per64`` (:47-55), i.i.d. with PER = numerator / 64, the
  FPGA's parameterisation: a random word is drawn per symbol and the symbol
  is erased when its low 6 bits are below the numerator;
* ``gilbert_elliott_erasures`` (:58-95), the two-state bursty channel: a
  Markov chain over the symbol axis, two uniforms per symbol (the erasure
  draw, then the state draw), the batch axis vectorised;
* ``gilbert_elliott_steady_state`` (:98-101) and ``apply_erasures`` (:104).

Random numbers come from an explicit ``torch.Generator``; they differ from
``jax.random``'s stream, so tests hand both sides the same NumPy inputs (or
compare statistics). The Gilbert-Elliott chain is a function of the drawn
uniforms (:func:`gilbert_elliott_chain`), so a test can feed it the
``(n, batch, 2)`` uniforms that the JAX version draws and compare masks.

Erasures are out of band: a bool mask plus the invariant that erased value
slots hold zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GilbertElliottParams(NamedTuple):
    """State 0 = Good (PER ``alpha``), state 1 = Bad (PER ``beta``);
    P(G->B) = transition / bias, P(B->G) = transition."""

    alpha: float
    beta: float
    transition: float = 0.1
    bias: float = 10.0


def iid_erasures(
    shape: tuple[int, ...],
    per: float,
    *,
    generator: torch.Generator,
    device: torch.device | str,
) -> torch.Tensor:
    """i.i.d. erasure mask, P(erased) = per (``<=`` as the JAX version)."""
    return torch.rand(shape, generator=generator, device=device) <= per


def iid_erasures_per64(
    shape: tuple[int, ...],
    per_numerator: int,
    *,
    generator: torch.Generator,
    device: torch.device | str,
) -> torch.Tensor:
    """i.i.d. erasures with PER = per_numerator / 64: one random 32-bit
    word per symbol, erased when its low 6 bits are below the numerator."""
    bits = torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=generator,
                         device=device)
    return (bits & 63) < per_numerator


def gilbert_elliott_chain(
    u: torch.Tensor,
    params: GilbertElliottParams,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain's steps on given uniforms ``u`` (n, batch, 2): symbol i of
    every frame is erased when ``u[i, :, 0] <=`` its state's PER, then the
    state moves on ``u[i, :, 1]``. ``init_state`` (batch,) int32 defaults to
    Good. Returns (mask (batch, n) bool, final_state (batch,) int32)."""
    n, batch, _ = u.shape
    state = (torch.zeros((batch,), dtype=torch.int32, device=u.device)
             if init_state is None else init_state.to(torch.int32))
    p_gb = params.transition / params.bias
    p_bg = params.transition
    mask = torch.empty((n, batch), dtype=torch.bool, device=u.device)
    for i in range(n):
        bad = state == 1
        mask[i] = u[i, :, 0] <= torch.where(bad, params.beta, params.alpha)
        flip = torch.where(bad, u[i, :, 1] <= p_bg, u[i, :, 1] <= p_gb)
        state = torch.where(flip, 1 - state, state)
    return mask.t().contiguous(), state


def gilbert_elliott_erasures(
    batch: int,
    n: int,
    params: GilbertElliottParams,
    init_state: torch.Tensor | None = None,
    *,
    generator: torch.Generator,
    device: torch.device | str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(batch, n) masks from the Gilbert-Elliott chain, two uniforms per
    symbol. Pass the returned final state back as ``init_state`` to carry
    bursts across codewords. Returns (mask, final_state)."""
    u = torch.rand((n, batch, 2), generator=generator, device=device)
    return gilbert_elliott_chain(u, params, init_state)


def gilbert_elliott_steady_state(params: GilbertElliottParams) -> float:
    """Analytic average erasure rate (Matlab/Bursty_Error_Channel_Model.m:20-24)."""
    p_bad = (1.0 / params.bias) / (1.0 + 1.0 / params.bias)
    return (1.0 - p_bad) * params.alpha + p_bad * params.beta


def apply_erasures(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the erased slots. ``values`` is (B, n) or (B, n, W); ``mask``
    is (B, n)."""
    if values.dim() == mask.dim() + 1:
        mask = mask[..., None]
    return values.masked_fill(mask, 0)
