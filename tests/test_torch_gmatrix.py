"""The port's generator-matrix tools (``codes/gmatrix.py``) against the JAX
package's, on the CPU.

tests/test_gmatrix.py is the template: each port function is held exactly
against its JAX counterpart on the same NumPy inputs (random GF(2)
matrices from fixed seeds, the toy codes, a shipped code), and raises
where JAX's raises.
"""

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes import gmatrix as jgm
from ldpc_erasure_codes_tpu.codes import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu_torch.codes import get_code, gmatrix, toy_code


@pytest.mark.parametrize("seed", range(6))
def test_row_reduce_rank_inverse_match_jax(seed):
    """``gf2_row_reduce``, ``gf2_rank`` and ``inv_gf2`` on square and wide
    random matrices, singular ones included."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        n = int(rng.integers(2, 12))
        a = rng.integers(0, 2, size=(n, n + int(rng.integers(0, 3))), dtype=np.uint8)
        red, piv = gmatrix.gf2_row_reduce(a)
        jred, jpiv = jgm.gf2_row_reduce(a)
        np.testing.assert_array_equal(red, jred)
        assert piv == jpiv and gmatrix.gf2_rank(a) == jgm.gf2_rank(a)
        sq = a[:, :n]
        if jgm.gf2_rank(sq) < n:
            with pytest.raises(ValueError):
                gmatrix.inv_gf2(sq)
        else:
            np.testing.assert_array_equal(gmatrix.inv_gf2(sq), jgm.inv_gf2(sq))
    with pytest.raises(ValueError):
        gmatrix.inv_gf2(np.ones((2, 3), np.uint8))


@pytest.mark.parametrize("n,k,seed", [(40, 24, 3), (30, 18, 5)])
def test_systematic_transform_matches_jax(n, k, seed):
    """``rearrange_columns`` and ``systematic_g_from_h`` on the toy codes
    (the same seed gives the same H on both sides): the same permutation
    and G, with G . H_perm^T = 0."""
    h = toy_code(n=n, k=k, seed=seed).h_dense
    np.testing.assert_array_equal(h, jax_toy_code(n=n, k=k, seed=seed).h_dense)
    for got, want in zip(gmatrix.rearrange_columns(h), jgm.rearrange_columns(h)):
        np.testing.assert_array_equal(got, want)
    g, perm = gmatrix.systematic_g_from_h(h)
    jg, jperm = jgm.systematic_g_from_h(h)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal((h[:, perm] @ g.T) & 1, 0)
    with pytest.raises(ValueError):
        gmatrix.rearrange_columns(np.zeros((3, 6), np.uint8))


def test_systematic_transform_of_shipped_code_matches_jax():
    h = get_code("n2040_k1530").h_dense
    np.testing.assert_array_equal(h, jax_get_code("n2040_k1530").h_dense)
    g, perm = gmatrix.systematic_g_from_h(h)
    jg, jperm = jgm.systematic_g_from_h(h)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(perm, jperm)


def test_ml_decodable_matches_jax():
    """The batched rank oracle on no erasures, more than n - k, and random
    patterns, and a single (n,) pattern."""
    g, _ = gmatrix.systematic_g_from_h(toy_code(n=30, k=18, seed=5).h_dense)
    rng = np.random.default_rng(1)
    pats = rng.random((16, 30)) < 0.25
    pats[0] = False
    pats[1, :13] = True
    got = gmatrix.ml_decodable(g, pats)
    np.testing.assert_array_equal(got, jgm.ml_decodable(g, pats))
    assert got[0] and not got[1] and got.dtype == bool
    np.testing.assert_array_equal(gmatrix.ml_decodable(g, pats[2]), jgm.ml_decodable(g, pats[2]))


@pytest.mark.parametrize("systematic", [True, False])
def test_random_g_rank_study_matches_jax(systematic):
    """The same seed draws the same matrices and survivors: equal
    histograms and block error rates."""
    st = gmatrix.random_g_rank_study(15, 10, trials=120, seed=2, systematic=systematic)
    js = jgm.random_g_rank_study(15, 10, trials=120, seed=2, systematic=systematic)
    assert (st.n, st.k, st.trials) == (js.n, js.k, js.trials) == (15, 10, 120)
    np.testing.assert_array_equal(st.rank_deficit_hist, js.rank_deficit_hist)
    assert st.block_error_rate == js.block_error_rate
