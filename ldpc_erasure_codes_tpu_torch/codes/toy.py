"""Tiny triangular test codes for unit tests and sharding dry runs.

Counterpart of ``ldpc_erasure_codes_tpu/codes/toy.py`` (:16-42): random
source-region support plus the triangle/staircase parity region
(Hgen_no6cycles_systematic_encoding.m:264-273), with no girth conditioning,
so only for plumbing tests, not FER studies. The same seed gives the same H
(and the same GF(256) lift) as the JAX function.
"""

from __future__ import annotations

import numpy as np

from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode, from_h_dense


def toy_code(
    n: int = 48,
    k: int = 32,
    row_weight: int = 4,
    seed: int = 0,
    gf_order: int = 2,
    name: str | None = None,
) -> LDPCCode:
    """Random systematic triangle-form (n, k) code.

    Row i has the triangle diagonal at column k+i, the staircase subdiagonal
    at k+i-1 (i > 0), and ``row_weight - 2`` random source-region neighbours.
    ``gf_order=256`` lifts it with seed ``seed + 1``.
    """
    m = n - k
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), dtype=np.uint8)
    for i in range(m):
        h[i, k + i] = 1
        if i > 0:
            h[i, k + i - 1] = 1
        nsrc = max(1, row_weight - (2 if i > 0 else 1))
        cols = rng.choice(k, size=min(nsrc, k), replace=False)
        h[i, cols] = 1
    code = from_h_dense(h, name or f"toy_n{n}_k{k}", rs_n=0, rs_k=0)
    if gf_order == 256:
        code = code.lift_to_gf256(seed=seed + 1)
    return code
