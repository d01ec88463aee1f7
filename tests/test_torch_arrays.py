"""The port's code loading and tables against the JAX package's.

Each side reads its own copy of the shipped ``.npz`` codes (byte-identical,
``tests/test_torch_standalone.py``); the port derives its
encoder tables in NumPy on its own, and they must equal the JAX package's
``ops.arrays._host_arrays`` field by field.
"""

import os

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops.arrays import _host_arrays
import ldpc_erasure_codes_tpu_torch
from ldpc_erasure_codes_tpu_torch.codes.io import DATA_DIR, from_vlist, get_code, list_codes
from ldpc_erasure_codes_tpu_torch.ops.arrays import (
    FIELDS,
    code_arrays,
    code_arrays_from_numpy,
    host_arrays,
)

SHIPPED = ["n2000_k1000", "n2040_k1530", "n4000_k2000", "n4080_k3060"]


def test_list_codes():
    assert list_codes() == SHIPPED
    pkg = os.path.dirname(os.path.abspath(ldpc_erasure_codes_tpu_torch.__file__))
    assert os.path.commonpath([os.path.abspath(DATA_DIR), pkg]) == pkg, DATA_DIR


@pytest.mark.parametrize("name", SHIPPED)
def test_get_code_matches_jax(name):
    ours, ref = get_code(name), jax_get_code(name)
    assert (ours.name, ours.n, ours.k, ours.m, ours.dmax, ours.gf_order) == (
        ref.name, ref.n, ref.k, ref.m, ref.dmax, ref.gf_order,
    )
    for f in ("vlist_idx", "vlist_len", "vlist_val"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("name", SHIPPED)
def test_code_arrays_match_jax_host_arrays(name):
    ref = _host_arrays(jax_get_code(name))
    ours = code_arrays(get_code(name), "cpu")
    got = ours.to_numpy()
    for f in FIELDS:
        assert got[f].dtype == np.int32, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(host_arrays(get_code(name))["enc_par_idx"], ref["enc_par_idx"])
    assert ours.min_n == ours.n == ref["h"].shape[1]
    assert all(getattr(ours, f).is_contiguous() for f in FIELDS)
    # h: the dense support of H, as _host_arrays derives it; h_words packs it.
    assert got["h"].dtype == np.int8 == ref["h"].dtype
    np.testing.assert_array_equal(got["h"], ref["h"])
    want_words = np.packbits(ref["h"].astype(bool), axis=1, bitorder="little")
    want_words = np.pad(want_words, ((0, 0), (0, -want_words.shape[1] % 4))).view(np.uint32)
    np.testing.assert_array_equal(ours.h_words.numpy().view(np.uint32), want_words)
    from_jax = code_arrays_from_numpy(ref, "cpu")
    for f in (*FIELDS, "h", "h_words"):
        assert torch.equal(getattr(from_jax, f), getattr(ours, f)), f


def test_code_arrays_from_numpy_round_trip():
    ref = _host_arrays(jax_get_code("n2040_k1530"))
    arrays = code_arrays_from_numpy(ref, torch.device("cpu"))
    back = arrays.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], ref[f], err_msg=f)
    again = code_arrays_from_numpy(back, "cpu").to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(again[f], back[f], err_msg=f)
    assert (arrays.m, arrays.dmax, arrays.min_n) == (510, 14, 2040)


def test_get_code_refuses_what_is_not_ported():
    # The GF(256) lifts are ported (tests/test_torch_nb.py); unknown codes
    # and their lifts are refused.
    assert get_code("n2040_k1530_gf256").gf_order == 256
    with pytest.raises(KeyError):
        get_code("n7_k3")
    with pytest.raises(KeyError):
        get_code("n7_k3_gf256")


def test_tables_are_validated():
    code = get_code("n2000_k1000")
    host = host_arrays(code)
    bad = dict(host, vlist_len=host["vlist_len"] + code.dmax)
    with pytest.raises(ValueError):
        code_arrays_from_numpy(bad, "cpu")
    neg = dict(host, enc_src_idx=host["enc_src_idx"] - 2000)
    with pytest.raises(ValueError):
        code_arrays_from_numpy(neg, "cpu")
    # h must be the Vlist's support, one row per check.
    flipped = host["h"].copy()
    flipped[0, 0] ^= 1
    with pytest.raises(ValueError):
        code_arrays_from_numpy(dict(host, h=flipped), "cpu")
    with pytest.raises(ValueError):
        code_arrays_from_numpy(dict(host, h=host["h"][1:]), "cpu")
    # A parity neighbour above the diagonal is not triangle form.
    idx = np.array([[0, 2, 3], [1, 3, 4]], dtype=np.int32)
    upper = from_vlist("upper", 4, 2, idx, np.array([3, 2]))
    with pytest.raises(ValueError):
        host_arrays(upper)
