"""The GF(256) elimination in the kernel's form, on the CPU.

``csrc/elim.cu``'s GF(256) kernel tables the nibble products of the pivot
row as it stands once per column and folds the normalisation into the
factors: the pivot row becomes its table at ``pinv``, every other row with
byte f != 0 takes ``row ^= table[f * pinv]``. Its plain version
``gf256_eliminate_tables_reference`` is held bit for bit against the JAX
package's ``pallas_elim.gf256_eliminate`` in interpret mode (the cubes of
tests/test_pallas_elim.py) and against the column order's plain version;
the nibble products themselves against the product table. The kernel runs
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops.pallas_elim import gf256_eliminate as jax_gf256_eliminate
from ldpc_erasure_codes_tpu_torch.gf.ops import gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import elim, nbmm
from test_torch_ge_nb import _nb_cube
from torch_port_cases import random_words, to_torch


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cut", [False, True], ids=["a_words_0", "a_words_wa"])
def test_tables_reference_matches_pallas(cut):
    """Both a_words modes, on cubes where some frames fail and some do not."""
    r, nreal, emax, a_words = _nb_cube(5 if cut else 2, cut)
    j_r, j_piv, j_fail = (np.asarray(x) for x in jax_gf256_eliminate(
        jnp.asarray(r), jnp.asarray(nreal[None]), emax=emax, b_tile=128, interpret=True,
        a_words=a_words,
    ))
    cube = torch.from_numpy(np.ascontiguousarray(np.transpose(r, (2, 1, 0))).view(np.int32))
    nr = torch.from_numpy(nreal)
    got = elim.gf256_eliminate_tables_reference(cube, nr, emax=emax, a_words=a_words)
    np.testing.assert_array_equal(got[1].numpy(), j_piv.T)
    np.testing.assert_array_equal(got[2].numpy(), j_fail[0] != 0)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.transpose(j_r, (2, 1, 0)))
    assert got[2].any() and not got[2].all()
    _equal(got, elim.gf256_eliminate_reference(cube, nr, emax=emax, a_words=a_words))


@pytest.mark.parametrize("a_words", [False, True], ids=["a_words_0", "a_words_wa"])
@pytest.mark.parametrize("m,c,emax", [(63, 32, 63), (65, 24, 64), (20, 3, 9)])
def test_tables_reference_matches_column_order(a_words, m, c, emax):
    """At the RS cube (63 x 32 words) and beside it: a frame with nreal 0,
    a frame whose pivot bytes are all 1, all-zero frames that fail."""
    rng = np.random.default_rng(m * c)
    b = 12
    by = rng.integers(0, 256, (b, m, 4 * c), dtype=np.uint8)
    by[rng.random(by.shape) < 0.5] = 0
    by[1] = 0
    by[1, : min(m, 4 * c), : min(m, 4 * c)] = np.eye(min(m, 4 * c), dtype=np.uint8)
    by[1, :, emax:] = rng.integers(0, 256, (m, 4 * c - emax), dtype=np.uint8)
    by[-2:] = 0
    nreal = rng.integers(1, emax + 1, b).astype(np.int32)
    nreal[0] = 0
    aw = -(-emax // 4) if a_words else 0
    if a_words:  # A bytes past nreal are zero, as the solver makes them
        cols = np.arange(4 * c)
        pad = (cols[None, :] >= nreal[:, None]) & (cols[None, :] < emax)
        by[np.broadcast_to(pad[:, None, :], by.shape)] = 0
    cube, nr = torch.from_numpy(by.view(np.int32).copy()), torch.from_numpy(nreal)
    got = elim.gf256_eliminate_tables_reference(cube, nr, emax=emax, a_words=aw)
    _equal(got, elim.gf256_eliminate_reference(cube, nr, emax=emax, a_words=aw))
    assert got[2][-2:].all() and not got[2][1]


def test_nibble_products_cover_every_coefficient():
    """lo[c & 15] ^ hi[c >> 4] of ``_nibble_products`` is c times the word
    for every coefficient 0..255, by the product table and by the
    double-and-add product."""
    x = to_torch(random_words(np.random.default_rng(7), (3, 5)))
    lo, hi = nbmm._nibble_products(x)
    for c in range(256):
        got = lo[:, c & 15] ^ hi[:, c >> 4]
        assert torch.equal(got, gf_mul_packed(x, c))
        assert torch.equal(got, gf_mul_packed(x, torch.tensor(c)))
