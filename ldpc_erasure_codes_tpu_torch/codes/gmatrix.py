"""Generator-matrix machinery over GF(2) (host-side NumPy).

A copy of ``ldpc_erasure_codes_tpu/codes/gmatrix.py`` (:26-165) for the
port, which imports nothing of the JAX package; the same seed gives the
same study.

Covers the reference's G-side tool chain for codes whose H is *not* in
triangle form:

* GF(2) matrix inverse (Matlab/inv_GF2.m:1-20 — column-by-column solves);
* column rearrangement making the leading square block of H invertible
  (Matlab/rearrange_cols.m:1-52);
* the systematic transform ``H -> G = [I | P^T]``
  (Matlab/LDPCErasureCodes.m:31-43);
* the `gfrank` decodability oracle — ML decoding succeeds iff the received
  columns of G span rank k (Matlab/LDPCErasureCodes.m:108-115);
* the random-code MDS-gap rank study (Matlab/ErasureCodePerformance.m:1-114).

All of it is per-code one-time host work; the decode path consumes the
result through the standard CodeArrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def gf2_row_reduce(a: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-reduce a copy of ``a`` over GF(2); returns (rref, pivot columns)."""
    a = (np.asarray(a) & 1).astype(np.uint8).copy()
    rows, cols = a.shape
    piv_cols: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        hits = np.nonzero(a[r:, c])[0]
        if hits.size == 0:
            continue
        p = r + hits[0]
        if p != r:
            a[[r, p]] = a[[p, r]]
        elim = np.nonzero(a[:, c])[0]
        for i in elim:
            if i != r:
                a[i] ^= a[r]
        piv_cols.append(c)
        r += 1
    return a, piv_cols


def gf2_rank(a: np.ndarray) -> int:
    """Rank over GF(2) (the Comms-toolbox ``gfrank`` equivalent)."""
    _, piv = gf2_row_reduce(a)
    return len(piv)


def inv_gf2(a: np.ndarray) -> np.ndarray:
    """Inverse of a square GF(2) matrix; raises ValueError when singular.

    (Matlab/inv_GF2.m solves A x = e_i per column with gflineq; one combined
    Gauss-Jordan on [A | I] is the same arithmetic.)
    """
    a = (np.asarray(a) & 1).astype(np.uint8)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("inv_gf2 needs a square matrix")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    red, piv = gf2_row_reduce(aug)
    if piv[:n] != list(range(n)):
        raise ValueError("matrix is singular over GF(2)")
    return red[:, n:]


def rearrange_columns(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Permute columns of H so the *trailing* m x m block is invertible.

    Returns (h_permuted, perm) with ``h_permuted = h[:, perm]``. Pivot columns
    of the row reduction (an information set complement) are moved to the
    back. Mirrors the role of Matlab/rearrange_cols.m (which makes the
    *leading* block invertible; the trailing convention matches this
    framework's ``H = [A | L]`` layout).
    """
    h = (np.asarray(h) & 1).astype(np.uint8)
    m, n = h.shape
    _, piv = gf2_row_reduce(h)
    if len(piv) < m:
        raise ValueError(f"H is rank deficient: rank {len(piv)} < m={m}")
    piv_set = set(piv)
    rest = [c for c in range(n) if c not in piv_set]
    perm = np.asarray(rest + piv, dtype=np.int64)
    return h[:, perm], perm


def systematic_g_from_h(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Systematic generator from an arbitrary full-rank H.

    Returns (g, perm): ``g`` is (k, n) = [I_k | P] with
    ``g @ h[:, perm].T == 0 (mod 2)``; ``perm`` is the column permutation
    applied to H. Reference pipeline: rearrange -> invert the square block ->
    ``H_sys = C2^-1 H`` -> read off G (Matlab/LDPCErasureCodes.m:31-43).
    """
    hp, perm = rearrange_columns(h)
    m, n = hp.shape
    k = n - m
    c2 = hp[:, k:]
    c2i = inv_gf2(c2)
    a_sys = (c2i @ hp[:, :k]) & 1  # H_sys = [A_sys | I]
    g = np.concatenate([np.eye(k, dtype=np.uint8), a_sys.T], axis=1)
    return g, perm


def ml_decodable(g: np.ndarray, erased: np.ndarray) -> np.ndarray:
    """Batched `gfrank` oracle: can ML decoding recover each codeword?

    True iff the non-erased columns of G have rank k
    (Matlab/LDPCErasureCodes.m:108-115). ``erased`` is (B, n) bool (or (n,)).
    """
    g = (np.asarray(g) & 1).astype(np.uint8)
    k = g.shape[0]
    erased = np.atleast_2d(np.asarray(erased, dtype=bool))
    return np.asarray(
        [gf2_rank(g[:, ~e]) == k for e in erased], dtype=bool
    )


@dataclasses.dataclass
class RankStudy:
    """MDS-gap statistics of an (n, k) random binary code ensemble.

    ``rank_deficit_hist[d]`` counts trials where the received-column rank was
    k - d when exactly k symbols arrive — an MDS code would always have d=0;
    the histogram measures the random ensemble's gap
    (Matlab/ErasureCodePerformance.m semantics)."""

    n: int
    k: int
    trials: int
    rank_deficit_hist: np.ndarray

    @property
    def block_error_rate(self) -> float:
        return 1.0 - self.rank_deficit_hist[0] / self.trials


def random_g_rank_study(
    n: int, k: int, trials: int = 1000, seed: int = 0, systematic: bool = True
) -> RankStudy:
    """Sample random generator matrices, give each trial exactly k surviving
    symbols, and histogram the rank deficit of the received columns."""
    rng = np.random.default_rng(seed)
    hist = np.zeros(k + 1, dtype=np.int64)
    for _ in range(trials):
        if systematic:
            g = np.concatenate(
                [
                    np.eye(k, dtype=np.uint8),
                    rng.integers(0, 2, size=(k, n - k), dtype=np.uint8),
                ],
                axis=1,
            )
        else:
            g = rng.integers(0, 2, size=(k, n), dtype=np.uint8)
        keep = rng.choice(n, size=k, replace=False)
        d = k - gf2_rank(g[:, keep])
        hist[d] += 1
    return RankStudy(n=n, k=k, trials=trials, rank_deficit_hist=hist)
