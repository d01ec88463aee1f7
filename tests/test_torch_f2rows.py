"""The list route of the port's dense GF(2) syndrome ``f2_matvec_wide``,
on the CPU.

``f2_matrix_rows`` lists each row's set columns of a packed matrix; the
list route's plain version sums those rows and is held against the JAX
package's ``pallas_nbmm.f2_matvec_wide`` in interpret mode (as
tests/test_pallas_nbmm.py runs it), with bits past K set in the port's
packed matrix and ignored. The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py). GF(2) sums are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu.ops.pallas_nbmm import f2_matvec_wide as jax_f2_matvec_wide
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import nbmm
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, pack_bits
from torch_port_cases import random_words, to_port_code, to_torch, to_words

SHIPPED = ("n2040_k1530", "n2000_k1000", "n4000_k2000", "n4080_k3060")


@pytest.mark.parametrize("name", SHIPPED)
def test_matrix_rows_equal_the_vlist(name):
    """Each row's list from the packed H is the check's Vlist, ascending,
    padded with n to the largest degree; the list route serves it."""
    code = get_code(name)
    arrays = code_arrays(code, "cpu")
    idx, length = nbmm.f2_matrix_rows(arrays.h_words, code.n)
    assert idx.shape == (code.m, int(code.vlist_len.max()))
    np.testing.assert_array_equal(length.numpy(), code.vlist_len)
    for r in range(code.m):
        d = int(code.vlist_len[r])
        np.testing.assert_array_equal(idx[r, :d].numpy(), np.sort(code.vlist_idx[r, :d]))
        assert (idx[r, d:] == code.n).all()
    assert torch.equal(arrays.h_rows[0], idx) and torch.equal(arrays.h_rows[1], length)
    assert nbmm.f2_slab_words(idx, code.n, 256) is not None


@pytest.mark.parametrize("which", ["toy", "n2040_k1530"])
def test_list_route_matches_pallas(which):
    """The list route's plain version on H's rows, listed from a packed H
    whose bits past K are set, against JAX's bit-plane MXU product on the
    clean H (rows padded to a multiple of 8)."""
    jcode = jax_toy_code() if which == "toy" else jax_get_code(which)
    n, m = jcode.n, jcode.m
    rng = np.random.default_rng(n)
    b, w = 3, 2
    y = random_words(rng, (b, n, w))
    y[rng.random((b, n)) < 0.2] = 0  # erased slots hold zero
    h = np.zeros((-(-m // 8) * 8, n), dtype=np.int8)
    h[:m] = jcode.h_dense != 0
    want = np.asarray(jax_f2_matvec_wide(
        jnp.asarray(np.ascontiguousarray(y).view(np.uint8)), jnp.asarray(h), interpret=True))
    want = want.view(np.uint32)[:, :m]
    kw = -(-n // 32)
    bits = np.zeros((m, 32 * kw), dtype=np.uint8)
    bits[:, :n] = h[:m]
    assert 32 * kw > n
    bits[:, n:] = 1  # past K: ignored
    h_words = pack_bits(torch.from_numpy(bits))
    idx, length = nbmm.f2_matrix_rows(h_words, n)
    values = to_torch(y)
    got = nbmm.f2_matvec_rows_reference(values, idx, length)
    np.testing.assert_array_equal(to_words(got), want)
    assert torch.equal(got, nbmm.f2_matvec_wide(values, h_words, rows=(idx, length)))
    arrays = code_arrays(to_port_code(jcode), "cpu")
    np.testing.assert_array_equal(to_words(nbmm.f2_matvec_rows_reference(
        to_torch(y), *arrays.h_rows)), want)


def test_routes_follow_row_weight_and_slab_size():
    """The list route takes rows up to K // F2_LIST_SPARSITY set columns,
    at the first preferred Wc that fits and is no wider than W rounded up
    to 4; heavier rows (a random dense matrix), or a slab that does not
    fit, take the bit scan."""
    rng = np.random.default_rng(3)
    k, m = 300, 10
    top = k // nbmm.F2_LIST_SPARSITY
    bits = np.zeros((m, k), dtype=np.uint8)
    bits[0, rng.choice(k, top, replace=False)] = 1
    idx, length = nbmm.f2_matrix_rows(pack_bits(torch.from_numpy(bits)), k)
    assert idx.shape == (m, top) and int(length[1]) == 0
    assert (idx[1] == k).all()
    assert nbmm.f2_slab_words(idx, k, 256) == nbmm.F2_SLAB_WORDS[0]
    assert nbmm.f2_slab_words(idx, k, 3) == 4
    bits[1, rng.choice(k, top + 1, replace=False)] = 1
    idx, _ = nbmm.f2_matrix_rows(pack_bits(torch.from_numpy(bits)), k)
    assert nbmm.f2_slab_words(idx, k, 256) is None
    for cols in (2048, 64):  # ~half the bits set
        dense = to_torch(random_words(rng, (20, cols // 32)))
        assert nbmm.f2_slab_words(nbmm.f2_matrix_rows(dense)[0], cols, 256) is None
    # K rows of 4 words over a block's shared memory: the bit scan.
    big = torch.zeros((4, 15000 // 32 + 1), dtype=torch.int32)
    assert nbmm.f2_slab_words(nbmm.f2_matrix_rows(big, 15000)[0], 15000, 4) is None


def test_matrix_rows_validates():
    with pytest.raises(ValueError):
        nbmm.f2_matrix_rows(torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        nbmm.f2_matrix_rows(torch.zeros((3, 2), dtype=torch.int32), 65)
    idx, length = nbmm.f2_matrix_rows(torch.zeros((3, 2), dtype=torch.int32), 0)
    assert idx.shape == (3, 1) and not length.any()
    values = torch.zeros((2, 5, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        nbmm.f2_matvec_rows_reference(values, idx, length.long())
