"""The plain twin of ``gf_matmul_batched``'s tiled kernel, on the CPU.

``gf_matmul_tiles_reference`` computes the product in the order of
``csrc/gfmm.cu``'s in-order kernel (tiles of R rows, per column the nibble
products of the rhs row, two table reads a row). It is held against the
TPU kernel ``gf_matmul_batched`` run in interpret mode at the shapes of
tests/test_torch_ge_nb.py::test_gf_matmul_batched_matches_pallas, and
against the column-loop plain version where E and m cross the tile and
panel edges. Finite-field integer work: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops.pallas_nbmm import gf_matmul_batched as jax_gf_matmul_batched
from ldpc_erasure_codes_tpu_torch.ops import nbmm


def test_gf_matmul_tiles_reference_matches_pallas():
    """The padded operands (m_pad 64, e_pad 56: R = 32, two tiles) give
    the TPU kernel's padded product, and the unpadded ones its top-left
    block."""
    rng = np.random.default_rng(7)
    b, m, e, w = 3, 63, 50, 256
    m_pad, e_pad = 64, 56
    rhs = rng.integers(0, 256, (b, m_pad, w), dtype=np.uint8)
    rhs[:, m:, :] = 0
    mats = np.pad(rng.integers(0, 256, (b, e, m), dtype=np.uint8),
                  ((0, 0), (0, e_pad - e), (0, m_pad - m)))
    want = np.asarray(jax_gf_matmul_batched(jnp.asarray(rhs), jnp.asarray(mats), interpret=True))
    got = nbmm.gf_matmul_tiles_reference(torch.from_numpy(rhs), torch.from_numpy(mats))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = nbmm.gf_matmul_tiles_reference(torch.from_numpy(rhs[:, :m].copy()),
                                          torch.from_numpy(mats[:, :e, :m].copy()))
    np.testing.assert_array_equal(rows.numpy(), want[:, :e])


@pytest.mark.parametrize("m", [1, 31, 33])
@pytest.mark.parametrize("e", [1, 16, 17, 33])
def test_gf_matmul_tiles_reference_matches_plain(m, e):
    """R = 16 (E <= 16) or 32, one tile or more with a short last one,
    against the column loop; the kernel's R is the apply's."""
    rng = np.random.default_rng(m * 100 + e)
    rhs = torch.from_numpy(rng.integers(0, 256, (2, m, 12), dtype=np.uint8))
    mats = torch.from_numpy(rng.integers(0, 256, (2, e, m), dtype=np.uint8))
    assert nbmm.gf_apply_rows(e) == (16 if e <= 16 else 32)
    np.testing.assert_array_equal(nbmm.gf_matmul_tiles_reference(rhs, mats).numpy(),
                                  nbmm.gf_matmul_batched_reference(rhs, mats).numpy())
