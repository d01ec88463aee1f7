"""The port's GF(256) arithmetic against the JAX package's ``gf``, on the CPU.

Tables, the scalar product (exhaustive over 256 x 256), the packed
four-bytes-per-word product, inverses, bit (un)packing and the bit image,
all bit-exact (finite-field integer arithmetic, no rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import gf as jgf
from ldpc_erasure_codes_tpu.gf import tables as jtables
from ldpc_erasure_codes_tpu_torch.gf import ops as pgf
from ldpc_erasure_codes_tpu_torch.gf import tables as ptables


@pytest.mark.parametrize("field", ["exp", "log", "mul", "inv"])
def test_tables_equal(field):
    np.testing.assert_array_equal(
        getattr(ptables.build_tables(), field), getattr(jtables.build_tables(), field)
    )


def test_gf_mul_exhaustive():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    want = np.asarray(jgf.gf_mul(jnp.asarray(a), jnp.asarray(b)))
    got = pgf.gf_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, ptables.gf_mul_np(a, b))


def test_gf_mul_packed_all_coefficients():
    """Every coefficient against random words, including words whose top
    byte has its high bit set (the arithmetic-shift trap of int32 ``>>``)."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(256, 64), dtype=np.uint32)
    words[:, 0] = 0xFFFFFFFF
    words[:, 1] = 0x80808080
    coef = np.arange(256, dtype=np.uint32)[:, None]
    want = np.asarray(jgf.gf_mul_packed(jnp.asarray(words), jnp.asarray(coef)))
    got = pgf.gf_mul_packed(torch.from_numpy(words.view(np.int32)), torch.from_numpy(coef.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # A Python int coefficient (the product table's row), on a strided view.
    wide = torch.from_numpy(np.repeat(words.view(np.int32)[:, None, :], 2, axis=1))
    for c in (0, 1, 2, 0x80, 0xFF, 0x53):
        got_c = pgf.gf_mul_packed(wide[:, 1], c)
        want_c = jgf.gf_mul_packed(jnp.asarray(words), jnp.uint32(c))
        np.testing.assert_array_equal(got_c.numpy().view(np.uint32), np.asarray(want_c))
    # Byte by byte against the table product.
    by = words.view(np.uint8).reshape(256, 64, 4)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint8).reshape(256, 64, 4),
        ptables.gf_mul_np(by, np.arange(256)[:, None, None]),
    )


def test_gf_inv_and_inverse_matrix():
    a = torch.arange(256, dtype=torch.uint8)
    got = pgf.gf_inv(a)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgf.gf_inv(jnp.arange(256, dtype=jnp.uint8))))
    assert int(got[0]) == 0
    np.testing.assert_array_equal(pgf.gf_mul(a[1:], got[1:]).numpy(), np.ones(255, np.uint8))
    rng = np.random.default_rng(1)
    m = rng.integers(0, 256, (12, 12), dtype=np.uint8)
    inv = ptables.gf_inv_matrix_np(m)
    np.testing.assert_array_equal(inv, jtables.gf_inv_matrix_np(m))
    np.testing.assert_array_equal(ptables.gf_matmul_np(m, inv), np.eye(12, dtype=np.uint8))
    with pytest.raises(ValueError):
        ptables.gf_inv_matrix_np(np.zeros((3, 3), np.uint8))


def test_bits_round_trip_and_bit_image():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (5, 24), dtype=np.uint8)
    bits = pgf.bytes_to_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jgf.bytes_to_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(pgf.bits_to_bytes(bits).numpy(), x)
    mat = rng.integers(0, 256, (6, 5), dtype=np.uint8)
    img = ptables.bit_image(mat)
    np.testing.assert_array_equal(img, jtables.bit_image(mat))
    # bits(u) @ image mod 2 == bits(u @ mat)
    u = rng.integers(0, 256, (3, 6), dtype=np.uint8)
    lhs = (pgf.bytes_to_bits(torch.from_numpy(u)).numpy().astype(np.int64) @ img) % 2
    want = pgf.bytes_to_bits(torch.from_numpy(ptables.gf_matmul_np(u, mat))).numpy()
    np.testing.assert_array_equal(lhs, want)


def test_as_words_refuses_bad_layouts():
    x = torch.zeros((2, 3, 8), dtype=torch.uint8)
    assert pgf.as_words(x).shape == (2, 3, 2)
    with pytest.raises(ValueError):
        pgf.as_words(torch.zeros((2, 3, 6), dtype=torch.uint8))
    with pytest.raises(ValueError):
        pgf.as_words(x.transpose(1, 2))
    with pytest.raises(ValueError):
        pgf.as_words(torch.zeros(17, dtype=torch.uint8)[1:].view(2, 8))
    with pytest.raises(TypeError):
        pgf.as_words(torch.zeros((2, 8), dtype=torch.int32))
