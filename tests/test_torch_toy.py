"""The port's ``toy_code`` against the JAX package's: the same H (Vlist,
degrees, coefficients) for the same arguments, binary and GF(256)."""

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes.toy import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code


@pytest.mark.parametrize("n,k,seed,gf_order", [
    (48, 32, 0, 2), (48, 32, 3, 2), (48, 32, 0, 256), (48, 32, 3, 256), (96, 64, 3, 256),
])
def test_toy_code_matches_jax(n, k, seed, gf_order):
    want = jax_toy_code(n=n, k=k, seed=seed, gf_order=gf_order)
    got = toy_code(n=n, k=k, seed=seed, gf_order=gf_order)
    assert (got.name, got.n, got.k, got.gf_order, got.rs_n, got.rs_k) == (
        want.name, want.n, want.k, want.gf_order, want.rs_n, want.rs_k)
    for field in ("vlist_idx", "vlist_len", "vlist_val"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    np.testing.assert_array_equal(got.h_dense_nb, np.asarray(want.h_dense_nb))
