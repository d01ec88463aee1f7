"""The port's encode against the JAX package's, bit-exact.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
``encode_packed_vmem`` in interpret mode, and the XLA ``encode_packed``. The
port's wrapper runs its plain version on CPU tensors; the CUDA kernel is
compared with it on the card (tests/test_torch_cuda.py and chip_smoke.py).
The slab route's level order and its plain version are checked here too.
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
from ldpc_erasure_codes_tpu_torch.ops._build import SMEM_LIMIT
from ldpc_erasure_codes_tpu_torch.ops.encode import (
    encode_levels_reference,
    encode_packed,
    slab_smem,
    slab_words,
)
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



SHIPPED = ("n2040_k1530", "n2000_k1000", "n4000_k2000", "n4080_k3060")


@pytest.mark.parametrize("name,levels", zip(SHIPPED, (27, 60, 77, 57)))
def test_encode_levels_order_rows_after_their_parity_neighbours(name, levels):
    """The slab route's level order: every parity neighbour of a row lies
    in an earlier level, each row's tables list its source and parity
    neighbours as codeword symbols (pad n, coefficient 1 on a binary code),
    and the shipped codes have 27/60/77/57 levels."""
    arrays = code_arrays(get_code(name), "cpu")
    lv = arrays.enc_levels
    m, n = arrays.m, arrays.n
    k = n - m
    assert lv.levels == levels
    order = lv.order.numpy().astype(np.int64)
    assert sorted(order.tolist()) == list(range(m))
    off = lv.level_off.numpy()
    assert off[0] == 0 and off[-1] == m and (np.diff(off) > 0).all()
    level_of = np.empty(m, dtype=np.int64)
    for level in range(levels):
        level_of[order[off[level]:off[level + 1]]] = level
    src_idx, par_idx = arrays.enc_src_idx.numpy(), arrays.enc_par_idx.numpy()
    for q, r in enumerate(order):
        par = par_idx[r][par_idx[r] < m]
        assert (level_of[par] < level_of[r]).all(), f"row {r}"
        assert level_of[r] == (1 + level_of[par].max() if par.size else 0)
        src = src_idx[r][src_idx[r] < k]
        for tab, coef, want in ((lv.src, lv.src_coef, src), (lv.par, lv.par_coef, k + par)):
            row = tab[q].numpy()
            np.testing.assert_array_equal(row[: want.size], want)
            assert (row[want.size:] == n).all()
            assert (coef[q, : want.size] == 1).all() and not coef[q, want.size:].any()
        assert int(lv.par_len[q]) == par.size


@pytest.mark.parametrize("gf_order", [2, 256])
@pytest.mark.parametrize("which", ["toy", "n2040_k1530"])
def test_levels_reference_matches_pallas_and_oracle(which, gf_order):
    """The plain version of the slab route's order (rows level by level)
    against JAX's ``encode_packed_vmem`` in interpret mode and the NumPy
    oracle's sequential encode, on the first word of each symbol."""
    from ldpc_erasure_codes_tpu.codes import toy_code as jax_toy_code
    from ldpc_erasure_codes_tpu.utils import oracle

    gf = gf_order == 256
    if which == "toy":
        jcode = jax_toy_code(n=60, k=36, seed=2, gf_order=gf_order)
    else:
        jcode = jax_get_code(f"{which}_gf256" if gf else which)
    rng = np.random.default_rng(gf_order)
    b, w = 3, 2
    if gf:
        src = rng.integers(0, 256, (b, jcode.k, 4 * w), dtype=np.uint8)
        port_src = torch.from_numpy(src)
    else:
        src = random_words(rng, (b, jcode.k, w))
        port_src = to_torch(src)
    want = np.asarray(encode_packed_vmem(device_arrays(jcode), jnp.asarray(src),
                                         gf_order=gf_order, b_tile=4, interpret=True))
    arrays = code_arrays(to_port_code(jcode), "cpu")
    got = encode_levels_reference(arrays, port_src, gf_order=gf_order).numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)
    for f in range(b):  # symbol 0 of each frame: a byte (GF(256)) or bit 0 (binary)
        if gf:
            cw = oracle.encode_triangular_nb(jcode, src[f, :, 0].astype(np.int64))
            np.testing.assert_array_equal(got[f, :, 0], cw)
        else:
            cw = oracle.encode_triangular(jcode, (src[f, :, 0] & 1).astype(np.int64))
            np.testing.assert_array_equal(got.view(np.uint32)[f, :, 0] & 1, cw)


@pytest.mark.parametrize("name", SHIPPED)
def test_every_shipped_code_takes_the_slab_route(name):
    """The route is chosen from the tables' sizes: each shipped code's
    slab fits at the main path's W = 256 in both fields, (4000,2000) and
    (4080,3060) below 16 words; a source of the wrong length is refused."""
    arrays = code_arrays(get_code(name), "cpu")
    for gf_order in (2, 256):
        wc = slab_words(arrays, 256, gf_order)
        assert wc is not None and slab_smem(arrays, wc, gf_order) <= SMEM_LIMIT
        assert (wc == 16) == (arrays.n <= 2040)
        assert slab_words(arrays, 3, gf_order) == 4
    with pytest.raises(ValueError, match="code k"):
        encode_packed(arrays, torch.zeros((1, arrays.n - arrays.m + 1, 2), dtype=torch.int32))
