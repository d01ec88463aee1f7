"""The port's GF(256) codes, encode and peel against the JAX package's.

The lift of ``n2040_k1530_gf256`` and the new ``CodeArrays`` fields are held
against the JAX registry and ``_host_arrays`` field by field. The encode and
the peel run on a small NB code (the JAX ``toy_code(n=96, k=64, seed=3,
gf_order=256)``, handed over as NumPy): the port's plain versions against
the JAX flat encode, the Pallas encode and peel kernels in interpret mode,
and the NumPy oracle. Everything is finite-field integer work: equality is
exact. Payloads are uint8 ``(B, n, W)`` bytes on both sides.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes import toy_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.arrays import _host_arrays
from ldpc_erasure_codes_tpu.ops.encode import encode_packed as jax_encode_packed
from ldpc_erasure_codes_tpu.ops.pallas_encode import encode_packed_vmem
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem
from ldpc_erasure_codes_tpu.utils import oracle
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.gf.tables import gf_matmul_np
from ldpc_erasure_codes_tpu_torch.ops.arrays import (
    FIELDS,
    NB_FIELDS,
    code_arrays,
    code_arrays_from_numpy,
)
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from torch_port_cases import to_port_code

B, WB = 4, 8  # frames, bytes per symbol


@functools.cache
def nb_jax_code():
    return toy_code(n=96, k=64, seed=3, gf_order=256)


def nb_arrays():
    return code_arrays(to_port_code(nb_jax_code()), "cpu")


@functools.cache
def nb_codewords(seed: int = 12) -> np.ndarray:
    """(B, n, WB) uint8 codewords of the small NB code, port-encoded."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (B, nb_jax_code().k, WB), dtype=np.uint8)
    return encode_packed(nb_arrays(), torch.from_numpy(src), gf_order=256).numpy()


def test_lift_matches_jax_registry():
    ours, ref = get_code("n2040_k1530_gf256"), jax_get_code("n2040_k1530_gf256")
    assert (ours.name, ours.n, ours.k, ours.gf_order) == (ref.name, ref.n, ref.k, 256)
    for f in ("vlist_idx", "vlist_len", "vlist_val", "h_dense_nb"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert ours.vlist_val[ours.vlist_idx < ours.n].min() >= 1


@pytest.mark.parametrize("name", ["n2040_k1530_gf256", "n2040_k1530", "toy_nb"])
def test_nb_fields_match_host_arrays(name):
    """The GF(256) fields of CodeArrays equal _host_arrays'; a binary code
    carries all-ones coefficients."""
    if name == "toy_nb":
        jcode, code = nb_jax_code(), to_port_code(nb_jax_code())
    else:
        jcode, code = jax_get_code(name), get_code(name)
    ref = _host_arrays(jcode)
    got = code_arrays(code, "cpu").to_numpy()
    for f in (*FIELDS, *NB_FIELDS):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in NB_FIELDS:
        assert got[f].dtype == np.uint8, f
    if code.gf_order == 2:
        assert set(np.unique(got["vlist_val"])) <= {0, 1}
        assert (got["enc_diag_inv"] == 1).all()
    from_jax = code_arrays_from_numpy(ref, "cpu")
    for f in NB_FIELDS:
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(), got[f], err_msg=f)


def test_code_arrays_refuse_inconsistent_coefficients():
    ref = dict(_host_arrays(nb_jax_code()))
    h_nb = ref["h_nb"].copy()
    r, c = np.argwhere(h_nb)[0]
    h_nb[r, c] = 0
    with pytest.raises(ValueError):
        code_arrays_from_numpy({**ref, "h_nb": h_nb}, "cpu")
    with pytest.raises(ValueError):
        code_arrays_from_numpy({**ref, "enc_par_val": ref["enc_par_val"][:-1]}, "cpu")


def test_encode_nb_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 256, (6, nb_jax_code().k, WB), dtype=np.uint8)
    arrays = nb_arrays()
    before = encode_packed.launches_gf256
    got = encode_packed(arrays, torch.from_numpy(src), gf_order=256)
    assert encode_packed.launches_gf256 == before  # CPU tensors take the plain version
    assert got.dtype == torch.uint8 and got.shape == (6, nb_jax_code().n, WB)
    jarr = device_arrays(nb_jax_code())
    want = np.asarray(jax_encode_packed(jarr, jnp.asarray(src), gf_order=256))
    np.testing.assert_array_equal(got.numpy(), want)
    vmem = encode_packed_vmem(jarr, jnp.asarray(src), gf_order=256, b_tile=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(vmem))
    # Every byte plane is a codeword: H . c = 0 over GF(256).
    h = nb_jax_code().h_dense_nb
    for f in range(2):
        assert not gf_matmul_np(h, got.numpy()[f]).any()


def _jax_peel(cw, mask, early_stop_k):
    out = peel_decode_vmem(
        device_arrays(nb_jax_code()), jnp.asarray(cw), jnp.asarray(mask), max_iters=50,
        early_stop_k=early_stop_k, b_tile=2, gf_order=256, schedule="seq", interpret=True,
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("per", [0.12, 0.3])
def test_peel_nb_matches_pallas_and_oracle(per):
    cw = nb_codewords()
    mask = np.random.default_rng(int(per * 100)).random((B, nb_jax_code().n)) < per
    arrays = nb_arrays()
    before = peel_decode.launches_gf256
    pv, pe, pi = peel_decode(arrays, torch.from_numpy(cw), torch.from_numpy(mask),
                             max_iters=50, gf_order=256)
    assert peel_decode.launches_gf256 == before
    pv, pe, pi = pv.numpy(), pe.numpy(), pi.numpy()
    jv, je, ji = _jax_peel(cw, mask, None)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pv[~pe], cw[~pe])
    assert not pv[pe].any()
    assert (mask & ~pe).any()  # the peel solved erasures
    if per == 0.3:
        assert pe.any()  # and the higher PER leaves stopping sets
    for f in range(B):
        recv = np.where(mask[f], oracle.ERASED, cw[f, :, 0].astype(np.int64))
        o_out, o_iters = oracle.peel_decode_nb(nb_jax_code(), recv, max_iters=50)
        np.testing.assert_array_equal(pe[f], o_out == oracle.ERASED)
        assert pi[f] == o_iters
        np.testing.assert_array_equal(pv[f, ~pe[f], 0], o_out[~pe[f]])


def test_peel_nb_first_k_stop_matches_pallas():
    """With early stop the TPU stops per tile, the port per frame: counts,
    the first-k mask and resolved values agree."""
    cw = nb_codewords()
    k = nb_jax_code().k
    mask = np.random.default_rng(9).random((B, nb_jax_code().n)) < 0.2
    pv, pe, pi = (x.numpy() for x in peel_decode(
        nb_arrays(), torch.from_numpy(cw), torch.from_numpy(mask), max_iters=50,
        early_stop_k=k, gf_order=256))
    jv, je, ji = _jax_peel(cw, mask, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pe[:, :k], je[:, :k])
    both = ~pe & ~je
    np.testing.assert_array_equal(pv[both], jv[both])
    np.testing.assert_array_equal(pv[~pe], cw[~pe])


def test_nb_wrappers_validate_payloads():
    arrays = nb_arrays()
    n, k = nb_jax_code().n, nb_jax_code().k
    er = torch.zeros((2, n), dtype=torch.bool)
    with pytest.raises(ValueError):  # width not a multiple of 4 bytes
        peel_decode(arrays, torch.zeros((2, n, 6), dtype=torch.uint8), er, gf_order=256)
    with pytest.raises(TypeError):  # GF(256) payloads are bytes
        peel_decode(arrays, torch.zeros((2, n, 2), dtype=torch.int32), er, gf_order=256)
    with pytest.raises(TypeError):
        encode_packed(arrays, torch.zeros((2, k, 2), dtype=torch.int32), gf_order=256)
    with pytest.raises(ValueError):
        encode_packed(arrays, torch.zeros((2, k, 8), dtype=torch.uint8), gf_order=16)
