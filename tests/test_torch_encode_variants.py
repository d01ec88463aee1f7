"""The port's encode variants and ``device_arrays`` against the JAX
package's, exact: ``encode_wide`` (the bit-plane encode), ``make_packed_encoder``
(the packed closure for one code) and ``encode_scan`` (the sequential
cross-check encoder), on the small generated code and on (2040,1530).
Inputs are made with NumPy from fixed seeds; the JAX side runs on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays as jax_device_arrays
from ldpc_erasure_codes_tpu.ops.encode import encode_scan as jax_encode_scan
from ldpc_erasure_codes_tpu.ops.encode import encode_wide as jax_encode_wide
from ldpc_erasure_codes_tpu.ops.encode import make_packed_encoder as jax_make_packed_encoder
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import (
    code_arrays,
    device_arrays,
    encode,
    encode_packed,
    encode_scan,
    encode_wide,
    make_packed_encoder,
)
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words


@functools.cache
def _codes(name: str):
    """(JAX code, port code): the small generated code or a shipped one."""
    if name == "small":
        jcode = small_jax_code()
        return jcode, to_port_code(jcode)
    return jax_get_code(name), get_code(name)


@pytest.mark.parametrize("name", ["small", "n2040_k1530"])
def test_encode_wide_and_scan_match_jax(name):
    """encode_wide on (B, S, k) bit planes and encode_scan on (B, k) bits
    equal JAX's, and both equal the port's encode."""
    jcode, code = _codes(name)
    jarr, arrays = jax_device_arrays(jcode), code_arrays(code, "cpu")
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 2, (3, 4, code.k), dtype=np.uint8)
    got = encode_wide(arrays, torch.from_numpy(planes))
    assert got.shape == (3, 4, code.n) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_encode_wide(jarr, jnp.asarray(planes))))
    bits = planes[:, 0]
    scan = encode_scan(arrays, torch.from_numpy(bits), code.n, code.k)
    np.testing.assert_array_equal(
        scan.numpy(), np.asarray(jax_encode_scan(jarr, jnp.asarray(bits), code.n, code.k)))
    np.testing.assert_array_equal(scan.numpy(), encode(arrays, torch.from_numpy(bits)).numpy())


@pytest.mark.parametrize("name", ["small", "n2040_k1530"])
def test_make_packed_encoder_matches_jax(name):
    """The closure on (B, k, W) words equals JAX's level-scheduled closure
    and encode_packed (tests/test_sim.py:224-235)."""
    jcode, code = _codes(name)
    src = random_words(np.random.default_rng(2), (3, code.k, 2))
    got = make_packed_encoder(code, device="cpu")(to_torch(src))
    want = np.asarray(jax_make_packed_encoder(jcode)(jnp.asarray(src)))
    np.testing.assert_array_equal(to_words(got), want)
    arrays = code_arrays(code, "cpu")
    assert torch.equal(got, encode_packed(arrays, to_torch(src)))


def test_make_packed_encoder_refuses_gf256():
    """JAX's closure sums without coefficients; the port takes binary codes
    only."""
    with pytest.raises(ValueError):
        make_packed_encoder(get_code("n2040_k1530_gf256"), device="cpu")


def test_device_arrays_on_the_named_device():
    """device_arrays(code, "cpu") equals code_arrays field by field; with no
    device it wants the card."""
    code = to_port_code(small_jax_code())
    got, want = device_arrays(code, "cpu"), code_arrays(code, "cpu")
    for f, t in want.to_numpy().items():
        np.testing.assert_array_equal(got.to_numpy()[f], t, err_msg=f)
    assert got.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device_arrays(code)
