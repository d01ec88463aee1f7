"""GF(2^8) arithmetic tables, in NumPy.

A copy of ``ldpc_erasure_codes_tpu/gf/tables.py`` (:27-179) for the port,
which imports nothing of the JAX package. The tables are built from first
principles (log/antilog over the primitive polynomial) once per process;
device code takes them as tensors (:mod:`.ops`) or as kernel arguments.

Primitive polynomial: the reference's ``[1 0 1 1 1 0 0 0 1]``, i.e.
x^8 + x^6 + x^5 + x^4 + 1 = 0x171
(Matlab/ErasureCodes_NonBinaryLDPCSim.m:70).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DEFAULT_PRIM_POLY = 0x171
GF_SIZE = 256


def _build_exp_log(prim_poly: int = DEFAULT_PRIM_POLY) -> tuple[np.ndarray, np.ndarray]:
    """Antilog (exp, doubled to 512 entries so ``exp[log a + log b]`` needs
    no mod 255) and log tables for generator alpha = x."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= prim_poly
    exp[255:510] = exp[0:255]
    return exp, log


@dataclasses.dataclass(frozen=True)
class GFTables:
    """GF(2^8) lookup tables as NumPy arrays.

    Attributes:
      exp: (512,) uint8 antilog table, doubled.
      log: (256,) int32 log table (log[0] = 0; callers mask zero).
      mul: (256, 256) uint8, mul[a, b] = a * b.
      inv: (256,) uint8 multiplicative inverse, inv[0] = 0 by convention.
    """

    exp: np.ndarray
    log: np.ndarray
    mul: np.ndarray
    inv: np.ndarray


@functools.lru_cache(maxsize=4)
def build_tables(prim_poly: int = DEFAULT_PRIM_POLY) -> GFTables:
    exp, log = _build_exp_log(prim_poly)
    la = log[np.arange(256)]
    mul = exp[(la[:, None] + la[None, :]) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = exp[(255 - log[1:]) % 255]
    return GFTables(exp=exp, log=log, mul=mul, inv=inv)


def gf_mul_np(a, b, tables: GFTables | None = None) -> np.ndarray:
    """Elementwise GF(256) product of NumPy arrays."""
    t = tables or build_tables()
    return t.mul[np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)]


def gf_inv_np(a, tables: GFTables | None = None) -> np.ndarray:
    t = tables or build_tables()
    return t.inv[np.asarray(a, dtype=np.int64)]


def gf_matvec_np(mat, vec, tables: GFTables | None = None) -> np.ndarray:
    """y[i] = XOR_j mat[i, j] * vec[j] over GF(256) (the oracle's host path)."""
    t = tables or build_tables()
    prod = t.mul[np.asarray(mat, dtype=np.int64), np.asarray(vec, dtype=np.int64)[None, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_matmul_np(a, b, tables: GFTables | None = None) -> np.ndarray:
    """C = A @ B over GF(256) for 2-D NumPy arrays (small sizes)."""
    t = tables or build_tables()
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    return np.bitwise_xor.reduce(t.mul[a[:, :, None], b[None, :, :]], axis=1)


def gf_inv_matrix_np(a, tables: GFTables | None = None) -> np.ndarray:
    """Inverse of a square matrix over GF(256) by Gauss-Jordan; raises
    ValueError when it is singular or not square."""
    t = tables or build_tables()
    a = np.asarray(a, dtype=np.uint8).copy()
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1).astype(np.int64)
    for col in range(n):
        piv_rows = np.nonzero(aug[col:, col])[0]
        if piv_rows.size == 0:
            raise ValueError("matrix is singular over GF(256)")
        piv = piv_rows[0] + col
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = t.mul[aug[col], t.inv[aug[col, col]]]
        other = np.nonzero(aug[:, col])[0]
        other = other[other != col]
        if other.size:
            aug[other] ^= t.mul[aug[other, col][:, None], aug[col][None, :]]
    return aug[:, n:].astype(np.uint8)


@functools.lru_cache(maxsize=4)
def _bit_image_basis(prim_poly: int = DEFAULT_PRIM_POLY) -> np.ndarray:
    """(256, 8, 8): basis[h, b, c] = bit c of h * x^b."""
    t = build_tables(prim_poly)
    basis = np.zeros((256, 8, 8), dtype=np.uint8)
    for b in range(8):
        prod = t.mul[:, 1 << b]
        for c in range(8):
            basis[:, b, c] = (prod >> c) & 1
    return basis


def bit_image(mat, prim_poly: int = DEFAULT_PRIM_POLY) -> np.ndarray:
    """Lift a GF(256) matrix (m, n) to its GF(2) image (8m, 8n): with bytes
    unpacked LSB first, ``bits(u) @ bit_image(G) mod 2 == bits(u @ G)``."""
    mat = np.asarray(mat, dtype=np.int64)
    m, n = mat.shape
    img = _bit_image_basis(prim_poly)[mat]  # (m, n, 8, 8) -> [i, j, b, c]
    return img.transpose(0, 2, 1, 3).reshape(m * 8, n * 8)
