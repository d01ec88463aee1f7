"""GF(2^8) arithmetic on torch tensors.

Counterpart of ``ldpc_erasure_codes_tpu/gf/ops.py``, whole: the table
products ``gf_mul_table`` (:49) and ``gf_mul_log`` (:61), the carry-less
product ``gf_mul_arith`` (:75) behind ``gf_mul`` (:100), the packed
four-bytes-per-word product ``gf_mul_packed`` with its SWAR
``_xtime_packed`` (:114-152), ``gf_inv`` (table), ``gf_add`` (:161), the
LSB-first bit (un)packing, and the binary-image products
``gf_matmul_bitimage`` (:187), ``mod2_matmul`` (:209) and ``int_matmul``
(:220). These are the plain PyTorch arithmetic of the GF(256) paths; the
CUDA kernels repeat it per word. In JAX they are XLA code, not Pallas, so
plain torch is their port.

The field polynomial is the reference's 0x171 wherever a function takes
no ``prim_poly`` (``gf_mul_arith``, ``gf_mul`` and ``gf_mul_packed`` do).
Packed words are ``torch.int32`` holding four GF(256) bytes, byte ``j`` in
bits ``8j..8j+7`` (the little-endian view of a uint8 tensor). torch's int32
``>>`` is arithmetic, so every right shift of a packed word is masked; the
masks above bit 30 are written as negative int32 literals.

The three products run in JAX as ``dot_general`` with int32 accumulation.
CUDA torch has no int32 matmul, so they run as ``torch.matmul`` in float64
on the operands' device, exact for every sum below 2**53 (and so for every
int32 sum), and convert back; float64 products never take TF32, whatever
the global switch says.
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


def gf_mul_table(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) product by one gather from the flat 64 KB
    product table (the reference's formulation,
    Matlab/My_RS_Decode_Optimize_With_GFTables.m:61-67); returns uint8."""
    flat = table("mul", a.device).reshape(-1)
    return flat[a.long() * 256 + b.long()]


def gf_mul_log(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) product by log/antilog gathers (the doubled
    antilog table removes the mod 255); returns uint8."""
    log, exp = table("log", a.device), table("exp", a.device)
    prod = exp[(log[a.long()] + log[b.long()]).long()]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(prod), prod)


def gf_mul_arith(a, b, prim_poly: int = DEFAULT_PRIM_POLY) -> torch.Tensor:
    """Elementwise GF(256) product (carry-less multiply, then reduction by
    ``prim_poly``), no table gathers; broadcasts, returns uint8."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b, device=a.device).to(torch.int32)
    prod = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.int32,
                       device=a.device)
    for i in range(8):
        prod = prod ^ ((a << i) * ((b >> i) & 1))
    for i in range(14, 7, -1):
        prod = prod ^ ((prim_poly << (i - 8)) * ((prod >> i) & 1))
    return prod.to(torch.uint8)


def gf_mul(a, b, prim_poly: int = DEFAULT_PRIM_POLY) -> torch.Tensor:
    """Elementwise GF(256) product (the arithmetic formulation,
    :func:`gf_mul_arith`; exhaustively equal to the table products)."""
    return gf_mul_arith(a, b, prim_poly)


def _xtime_packed(v: torch.Tensor, prim_poly: int = DEFAULT_PRIM_POLY) -> torch.Tensor:
    """Multiply-by-x of the four bytes of each int32 word: a byte that
    overflows its top bit wraps modulo the polynomial's low byte."""
    hi = (v >> 7) & _LOW_BIT
    return ((v << 1) & _HIGH_BITS) ^ (hi * (prim_poly & 0xFF))


def gf_mul_packed(words: torch.Tensor, coef, prim_poly: int = DEFAULT_PRIM_POLY) -> torch.Tensor:
    """Each byte of the int32 ``words`` times the byte ``coef`` (a tensor
    broadcastable against ``words``, values 0..255) in the field of
    ``prim_poly``: double-and-add over the coefficient's bits. A Python int
    coefficient in the default field takes the product table's row instead
    (one gather over the bytes; the plain loops call this once per check
    and neighbour). Returns int32 words."""
    if isinstance(coef, int) and prim_poly == DEFAULT_PRIM_POLY and words.stride(-1) == 1:
        row = table("mul", words.device)[coef]
        return row[words.view(torch.uint8).long()].view(torch.int32)
    c = torch.as_tensor(coef, device=words.device).to(torch.int32)
    acc = torch.zeros(torch.broadcast_shapes(words.shape, c.shape), dtype=torch.int32,
                      device=words.device)
    cur = words
    for i in range(8):
        acc = acc ^ (cur * ((c >> i) & 1))
        if i < 7:
            cur = _xtime_packed(cur, prim_poly)
    return acc


def gf_inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse (table); gf_inv(0) == 0. Returns uint8."""
    return table("inv", a.device)[a.long()]


def gf_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) addition is XOR (the reference's add table is bitxor,
    Matlab/Build_GF256_Lookup_Tables.m:57-67)."""
    return torch.bitwise_xor(a, b)


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


def _matmul_exact(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m over the last axis of ``x`` and the first of ``m``, for integer
    operands, as exact int64 sums (float64 products on the operands'
    device: exact below 2**53)."""
    return torch.matmul(x.to(torch.float64), m.to(torch.float64)).to(torch.int64)


def gf_matmul_bitimage(u: torch.Tensor, g_bits: torch.Tensor) -> torch.Tensor:
    """y = u @ G over GF(256) through a precomputed binary image of G.

    ``u`` (..., k) uint8; ``g_bits`` the (8k, 8n) 0/1 image from
    :func:`.tables.bit_image`. Returns (..., n) uint8: the bits' integer
    product, reduced mod 2 and packed."""
    acc = _matmul_exact(bytes_to_bits(u), g_bits)
    return bits_to_bytes(acc & 1)


def mod2_matmul(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(x @ m) mod 2 for 0/1 operands, as int8."""
    return (_matmul_exact(x, m) & 1).to(torch.int8)


def int_matmul(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Integer matmul with int32 results (for erasure counts), as JAX's
    int32 accumulation gives them."""
    return _matmul_exact(x, m).to(torch.int32)


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
