"""Reed-Solomon codes over GF(2^8) in the framework's parity-check form.

A copy of ``ldpc_erasure_codes_tpu/rs/code.py`` (NumPy only): the
Vandermonde generator ``G[r, c] = alpha^(r*c)``
(Matlab/Test_My_RS_Decode.m:30-37), its systematic form
``G_sys = inv(G[:, :k]) @ G`` (Matlab/ReedSolomonErasureCodes.m:31-32), and
RS(n, k) as a code with dense ``H = [P^T | I]``, so the GF(256) encoder and
Gauss-Jordan solver of the LDPC codes decode it.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode, from_h_dense
from ldpc_erasure_codes_tpu_torch.gf.tables import build_tables, gf_inv_matrix_np, gf_matmul_np


@functools.lru_cache(maxsize=16)
def rs_generator(n: int, k: int) -> np.ndarray:
    """(k, n) Vandermonde generator G[r, c] = alpha^(r*c) over GF(256)."""
    if not (0 < k <= n <= 255):
        raise ValueError(f"need 0 < k <= n <= 255, got ({n}, {k})")
    t = build_tables()
    r = np.arange(k)[:, None]
    c = np.arange(n)[None, :]
    return t.exp[(r * c) % 255].astype(np.uint8)


@functools.lru_cache(maxsize=16)
def rs_systematic_generator(n: int, k: int) -> np.ndarray:
    """(k, n) systematic generator G_sys = inv(G[:, :k]) @ G; G_sys[:, :k] = I."""
    g = rs_generator(n, k)
    gs = gf_matmul_np(gf_inv_matrix_np(g[:, :k]), g)
    if not np.array_equal(gs[:, :k], np.eye(k, dtype=np.uint8)):
        raise ArithmeticError("systematic generator is not [I | P]")
    return gs


def rs_code(n: int, k: int, name: str | None = None) -> LDPCCode:
    """RS(n, k) as a code: dense H = [P^T | I] from G_sys = [I | P]. The
    identity parity block is triangle form, so the systematic encoder and
    the solvers apply unchanged."""
    p = rs_systematic_generator(n, k)[:, k:]  # (k, m)
    m = n - k
    h = np.concatenate([p.T, np.eye(m, dtype=np.uint8)], axis=1)
    return from_h_dense(h, name or f"rs_n{n}_k{k}", rs_n=n, rs_k=k)


def analytic_rs_fer(n: int, k: int, per: float) -> float:
    """Exact MDS block-error rate under i.i.d. erasures,
    ``1 - sum_{i=0}^{n-k} C(n,i) p^i (1-p)^(n-i)`` (Matlab/scratch.m:30-38)."""
    q = 1.0 - per
    acc = 0.0
    for i in range(n - k + 1):
        acc += math.comb(n, i) * (per**i) * (q ** (n - i))
    return 1.0 - acc
