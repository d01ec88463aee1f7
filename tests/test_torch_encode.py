"""The port's encode against the JAX package's, bit-exact.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
``encode_packed_vmem`` in interpret mode, and the XLA ``encode_packed``. The
port's wrapper runs its plain version on CPU tensors; the CUDA kernel is
compared with it on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import encode_packed as jax_encode_packed
from ldpc_erasure_codes_tpu.ops.pallas_encode import encode_packed_vmem
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from torch_port_cases import (
    random_words,
    small_jax_code,
    to_port_code,
    to_torch,
    to_words,
)


@pytest.mark.parametrize("b,w", [(6, 3), (4, 1)])
def test_matches_pallas_encode_small_code(b, w):
    jcode = small_jax_code()
    src = random_words(np.random.default_rng(b * 10 + w), (b, jcode.k, w))
    want = np.asarray(
        encode_packed_vmem(device_arrays(jcode), jnp.asarray(src), b_tile=4, interpret=True)
    )
    arrays = code_arrays(to_port_code(jcode), "cpu")
    got = to_words(encode_packed(arrays, to_torch(src)))
    np.testing.assert_array_equal(got, want)


def test_matches_xla_encode_n2040():
    src = random_words(np.random.default_rng(1), (2, 1530, 4))
    want = np.asarray(
        jax_encode_packed(device_arrays(jax_get_code("n2040_k1530")), jnp.asarray(src))
    )
    arrays = code_arrays(get_code("n2040_k1530"), "cpu")
    got = to_words(encode_packed(arrays, to_torch(src)))
    np.testing.assert_array_equal(got, want)


def test_codewords_satisfy_every_check():
    code = get_code("n2000_k1000")
    src = random_words(np.random.default_rng(2), (3, code.k, 2))
    cw = to_words(encode_packed(code_arrays(code, "cpu"), to_torch(src)))
    np.testing.assert_array_equal(cw[:, : code.k], src)
    for r in range(code.m):
        nb = code.vlist_idx[r, : code.vlist_len[r]]
        assert not np.bitwise_xor.reduce(cw[:, nb], axis=1).any(), f"check {r}"


def test_wrapper_validates_and_counts_only_kernel_launches():
    arrays = code_arrays(get_code("n2000_k1000"), "cpu")
    src = torch.zeros((2, 1000, 4), dtype=torch.int32)
    before = encode_packed.launches
    encode_packed(arrays, src)
    assert encode_packed.launches == before  # CPU tensors take the plain version
    with pytest.raises(TypeError):
        encode_packed(arrays, src.to(torch.int64))
    with pytest.raises(ValueError):
        encode_packed(arrays, src[:, :, 0])
    with pytest.raises(ValueError):
        encode_packed(arrays, src.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):  # GF(256) frames are uint8 bytes
        encode_packed(arrays, src, gf_order=256)
    with pytest.raises(ValueError):
        encode_packed(arrays, src, gf_order=16)

