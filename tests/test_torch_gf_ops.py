"""The port's GF(256) device functions (``gf/ops.py``) against the JAX
package's, on the CPU.

``gf_mul_table``, ``gf_mul_log``, ``gf_mul_arith`` (both fields' primitive
polynomials) and ``gf_add`` over all 65536 pairs; ``gf_matmul_bitimage``,
``mod2_matmul`` and ``int_matmul`` on seeded NumPy operands, one of whose
sums passes 2**24 (float32 would round it; float64 is exact). Exact
equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import gf as jgf
from ldpc_erasure_codes_tpu import rs as jrs
from ldpc_erasure_codes_tpu_torch import gf

A, B = (x.reshape(-1).astype(np.uint8) for x in np.meshgrid(np.arange(256), np.arange(256)))


@pytest.mark.parametrize("name", ["gf_mul_table", "gf_mul_log", "gf_mul_arith", "gf_mul",
                                  "gf_add"])
def test_elementwise_over_all_pairs(name):
    got = getattr(gf, name)(torch.from_numpy(A), torch.from_numpy(B))
    want = np.asarray(getattr(jgf, name)(jnp.asarray(A), jnp.asarray(B)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if name != "gf_add":
        np.testing.assert_array_equal(got.numpy(), gf.gf_mul_np(A, B))


@pytest.mark.parametrize("poly", [0x11D, 0x171])
def test_arith_other_polynomial_matches_jax(poly):
    got = gf.gf_mul_arith(torch.from_numpy(A), torch.from_numpy(B), poly)
    want = np.asarray(jgf.gf_mul_arith(jnp.asarray(A), jnp.asarray(B), poly))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k,batch", [(255, 192, 4), (18, 10, 7)])
def test_bitimage_matmul_matches_jax(n, k, batch):
    g = jrs.rs_systematic_generator(n, k)
    g_bits = gf.bit_image(g)
    np.testing.assert_array_equal(g_bits, jgf.bit_image(g))
    u = np.random.default_rng(n).integers(0, 256, (batch, k), dtype=np.uint8)
    got = gf.gf_matmul_bitimage(torch.from_numpy(u), torch.from_numpy(g_bits))
    want = np.asarray(jgf.gf_matmul_bitimage(jnp.asarray(u), jnp.asarray(g_bits)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), gf.gf_matmul_np(u, g))


def test_mod2_matmul_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2, (3, 5, 96), dtype=np.int8)
    m = rng.integers(0, 2, (96, 40), dtype=np.int8)
    got = gf.mod2_matmul(torch.from_numpy(x), torch.from_numpy(m))
    want = np.asarray(jgf.mod2_matmul(jnp.asarray(x), jnp.asarray(m)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_matmul_exact_past_2_pow_24():
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (6, 300), dtype=np.int8)
    m = rng.integers(-128, 128, (300, 9), dtype=np.int8)
    x32 = rng.integers(0, 256, (2, 1100), dtype=np.int32)
    m32 = rng.integers(0, 256, (1100, 3), dtype=np.int32)
    x32[0, :] = 255  # sums near 1100 * 255 * 127.5 = 3.6e7 > 2**24, below 2**31
    for a, b in ((x, m), (x32, m32)):
        got = gf.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(jgf.int_matmul(jnp.asarray(a), jnp.asarray(b)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert int(np.abs(want).max()) > 1 << 24
    big = torch.from_numpy(x32).to(torch.float32) @ torch.from_numpy(m32).to(torch.float32)
    assert not np.array_equal(big.to(torch.int64).numpy(), x32.astype(np.int64) @ m32)
