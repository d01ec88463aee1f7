"""GF(2^8) arithmetic on torch tensors.

Counterpart of ``ldpc_erasure_codes_tpu/gf/ops.py``: the carry-less product
``gf_mul`` (:75-111), the packed four-bytes-per-word product
``gf_mul_packed`` with its SWAR ``_xtime_packed`` (:114-152), ``gf_inv``
(table) and the LSB-first bit (un)packing. These are the plain PyTorch
arithmetic of the GF(256) paths; the CUDA kernels repeat it per word.

The field polynomial is the reference's 0x171 throughout. Packed words
are ``torch.int32`` holding four GF(256) bytes, byte ``j`` in
bits ``8j..8j+7`` (the little-endian view of a uint8 tensor). torch's int32
``>>`` is arithmetic, so every right shift of a packed word is masked; the
masks above bit 30 are written as negative int32 literals.
"""

from __future__ import annotations

import functools

import torch

from ldpc_erasure_codes_tpu_torch.gf.tables import DEFAULT_PRIM_POLY, build_tables

# 0xFEFEFEFE as an int32: the bytes' bits 1..7 after a left shift.
_HIGH_BITS = 0xFEFEFEFE - (1 << 32)
_LOW_BIT = 0x01010101


@functools.cache
def _table(name: str, device: str) -> torch.Tensor:
    return torch.from_numpy(getattr(build_tables(), name).copy()).to(device)


def table(name: str, device: torch.device | str) -> torch.Tensor:
    """A GF(256) table (``exp``, ``log``, ``inv``, ``mul``) as a tensor of
    its NumPy type on ``device``, cached per device."""
    return _table(name, str(torch.device(device)))


def gf_mul(a, b) -> torch.Tensor:
    """Elementwise GF(256) product (carry-less multiply, then reduction by
    the primitive polynomial); broadcasts, returns uint8."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b, device=a.device).to(torch.int32)
    prod = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.int32,
                       device=a.device)
    for i in range(8):
        prod = prod ^ ((a << i) * ((b >> i) & 1))
    for i in range(14, 7, -1):
        prod = prod ^ ((DEFAULT_PRIM_POLY << (i - 8)) * ((prod >> i) & 1))
    return prod.to(torch.uint8)


def _xtime_packed(v: torch.Tensor) -> torch.Tensor:
    """Multiply-by-x of the four bytes of each int32 word: a byte that
    overflows its top bit wraps modulo the polynomial's low byte."""
    hi = (v >> 7) & _LOW_BIT
    return ((v << 1) & _HIGH_BITS) ^ (hi * (DEFAULT_PRIM_POLY & 0xFF))


def gf_mul_packed(words: torch.Tensor, coef) -> torch.Tensor:
    """Each byte of the int32 ``words`` times the byte ``coef`` (a tensor
    broadcastable against ``words``, values 0..255): double-and-add over
    the coefficient's bits. A Python int coefficient takes the product
    table's row instead (one gather over the bytes; the plain loops call
    this once per check and neighbour). Returns int32 words."""
    if isinstance(coef, int) and words.stride(-1) == 1:
        row = table("mul", words.device)[coef]
        return row[words.view(torch.uint8).long()].view(torch.int32)
    c = torch.as_tensor(coef, device=words.device).to(torch.int32)
    acc = torch.zeros(torch.broadcast_shapes(words.shape, c.shape), dtype=torch.int32,
                      device=words.device)
    cur = words
    for i in range(8):
        acc = acc ^ (cur * ((c >> i) & 1))
        if i < 7:
            cur = _xtime_packed(cur)
    return acc


def gf_inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse (table); gf_inv(0) == 0. Returns uint8."""
    return table("inv", a.device)[a.long()]


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n) -> int8 bits (..., 8n), LSB first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[..., :, None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Integer bits (..., 8n) -> uint8 (..., n), LSB first per byte."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def as_words(x: torch.Tensor, what: str = "payload") -> torch.Tensor:
    """The int32 word view (..., W/4) of a uint8 byte tensor (..., W):
    four bytes to a word, LSB first. The view is free; it needs a
    contiguous tensor, W % 4 == 0 and a storage offset that is a multiple
    of 4 bytes, and raises otherwise."""
    if x.dtype != torch.uint8:
        raise TypeError(f"{what} must be torch.uint8 bytes, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] % 4 != 0:
        raise ValueError(f"{what} width {tuple(x.shape)[-1:]} must be a multiple of 4 bytes")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.storage_offset() % 4 != 0:
        raise ValueError(f"{what} must start on a 4-byte boundary")
    return x.view(torch.int32)
