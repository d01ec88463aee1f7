"""The fused per64 erasure channel: mask draw and value zeroing in one pass.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_channel.py
::channel_apply_per64`` (:54-101), the analog of the FPGA's ``data_in``
kernel: one random word per symbol, the symbol erased when the word's low
six bits are below the numerator (PER = numerator / 64), and the erased
value slots zeroed in the same pass.

The TPU kernel's words come from its hardware PRNG, seeded per tile, and
cannot be reproduced. Here the word is word 0 of Philox-4x32-10 under the
key (seed, 0) at the counter (symbol, frame, 0, 0), so the mask depends on
(seed, frame, symbol) alone: the kernel (``csrc/channel.cu``) and the plain
version (:func:`philox4x32`, int64 tensor arithmetic) give the same mask,
on the card and on the CPU. As in the JAX package this is a stream apart
from ``channel.erasure.iid_erasures_per64`` with the same distribution; the
simulation's ``per64`` channel keeps ``iid_erasures_per64``.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build

_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * x, x int64 in
    [0, 2^32): x is split in 16-bit halves so that no product overflows."""
    xl, xh = x & 0xFFFF, x >> 16
    lo_part = a * xl  # < 2^48
    t = (lo_part >> 16) + a * xh  # < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32(counter: tuple, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox-4x32-10 (Random123's ``philox4x32``) on int64 tensors holding
    32-bit values: ``counter`` four broadcastable tensors (or ints), ``key``
    two ints. Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK32 for c in counter)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _words(values: torch.Tensor) -> torch.Tensor:
    """(B, n, W) int32 words, or uint8 (B, n, Wb) bytes (Wb % 4 == 0) viewed
    as words."""
    if values.dim() != 3:
        raise ValueError(f"values must be (B, n, W), got {tuple(values.shape)}")
    if values.dtype == torch.uint8:
        if values.shape[2] % 4:
            raise ValueError(f"byte frames need a width that is a multiple of 4, got "
                             f"{values.shape[2]}")
        return values.contiguous().view(torch.int32)
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32 words or uint8 bytes, got {values.dtype}")
    return values.contiguous()


def _check_num(per_numerator: int) -> int:
    num = int(per_numerator)
    if not 0 <= num <= 64:
        raise ValueError(f"per_numerator must be in [0, 64], got {num}")
    return num


def erase_per64(values: torch.Tensor, bits: torch.Tensor,
                per_numerator: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The masking rule on given random words ``bits`` (B, n): a symbol is
    erased when ``bits & 63`` is below the numerator, and its value slots
    are zeroed. Returns (received values, mask (B, n) bool)."""
    mask = (bits & 63) < _check_num(per_numerator)
    return values.masked_fill(mask[:, :, None], 0), mask


def channel_bits(shape: tuple[int, int], seed: int, device) -> torch.Tensor:
    """The random word of every symbol, (B, n) int64: Philox-4x32-10 word 0
    at the counter (symbol, frame, 0, 0) under the key (seed, 0)."""
    b, n = shape
    frames = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    syms = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return philox4x32((syms, frames, 0, 0), (int(seed), 0))[0]


def channel_apply_per64_reference(
    values: torch.Tensor, seed: int, per_numerator: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the Philox word of every symbol, then the
    masking rule (:func:`erase_per64`)."""
    words = _words(values)
    return erase_per64(values, channel_bits(tuple(words.shape[:2]), seed, values.device),
                       per_numerator)


def channel_apply_per64(
    values: torch.Tensor, seed: int, per_numerator: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw PER = per_numerator / 64 erasures on the device and zero the
    erased slots.

    Args:
      values: (B, n, W) int32 codeword words, or uint8 (B, n, Wb) byte
        frames (Wb % 4 == 0).
      seed: the call's seed (its low 32 bits key the generator).
      per_numerator: in [0, 64].

    Returns (received values, same shape and type; erasure mask (B, n)
    bool). CPU tensors take :func:`channel_apply_per64_reference`; CUDA
    tensors launch the kernel (or raise). ``channel_apply_per64.launches``
    counts kernel launches.
    """
    words = _words(values)
    num = _check_num(per_numerator)
    if values.device.type == "cpu":
        return channel_apply_per64_reference(values, seed, num)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    b, n, w = words.shape
    out = torch.empty_like(words)
    mask = torch.empty((b, n), dtype=torch.bool, device=values.device)
    seed32 = int(seed) & _MASK32
    rc = _build.library().ldpc_channel_launch(
        words.data_ptr(), out.data_ptr(), mask.data_ptr(), b, n, w,
        seed32 - (1 << 32) if seed32 >= 1 << 31 else seed32, num,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(rc, "ldpc_channel_launch")
    channel_apply_per64.launches += 1
    return out.view(values.dtype).view(values.shape), mask


channel_apply_per64.launches = 0
