"""The port's Reed-Solomon codes and decoders against the JAX package's.

``rs_code`` (the systematic generator and the dense ``H = [P^T | I]``) and
its code tables are held against the JAX registry and ``_host_arrays``; the
encode, ``rs_decode`` (the byte Gauss-Jordan) and ``rs_decode_wide`` (the
three GF(256) GE kernels' path, plain versions here) against their JAX
counterparts on the same NumPy inputs, and against the MDS contract
(``verify_rs``). Finite-field integer work: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import rs as jrs
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.arrays import _host_arrays
from ldpc_erasure_codes_tpu_torch import rs
from ldpc_erasure_codes_tpu_torch.ops.arrays import FIELDS, NB_FIELDS, code_arrays
from ldpc_erasure_codes_tpu_torch.utils.verify import check_rs


@pytest.mark.parametrize("n,k", [(255, 192), (18, 10)])
def test_rs_code_matches_jax(n, k):
    np.testing.assert_array_equal(rs.rs_generator(n, k), jrs.rs_generator(n, k))
    np.testing.assert_array_equal(rs.rs_systematic_generator(n, k),
                                  jrs.rs_systematic_generator(n, k))
    ours, ref = rs.rs_code(n, k), jrs.rs_code(n, k)
    assert (ours.name, ours.n, ours.k, ours.rs_n, ours.rs_k, ours.gf_order) == (
        ref.name, ref.n, ref.k, ref.rs_n, ref.rs_k, ref.gf_order)
    for f in ("vlist_idx", "vlist_len", "vlist_val", "h_dense_nb"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    got = code_arrays(ours, "cpu").to_numpy()
    want = _host_arrays(ref)
    for f in (*FIELDS, *NB_FIELDS):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for per in (0.05, 0.15, 0.3):
        assert rs.analytic_rs_fer(n, k, per) == jrs.analytic_rs_fer(n, k, per)


def _rs_case(n, k, b, wb, seed, per=None, counts=None):
    """(port arrays, JAX arrays, codewords uint8 (B, n, WB), mask)."""
    arrays = code_arrays(rs.rs_code(n, k), "cpu")
    jarr = device_arrays(jrs.rs_code(n, k))
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (b, k, wb), dtype=np.uint8)
    cw = rs.rs_encode(arrays, torch.from_numpy(src))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jrs.rs_encode(jarr, jnp.asarray(src))))
    if counts is None:
        mask = rng.random((b, n)) < per
    else:
        mask = np.zeros((b, n), bool)
        for f, e in enumerate(counts):
            mask[f, rng.choice(n, e, replace=False)] = True
    return arrays, jarr, cw, torch.from_numpy(mask)


def test_rs_encode_bytes_matches_jax():
    arrays = code_arrays(rs.rs_code(18, 10), "cpu")
    src = np.random.default_rng(1).integers(0, 256, (6, 10), dtype=np.uint8)
    got = rs.rs_encode(arrays, torch.from_numpy(src))
    want = jrs.rs_encode(device_arrays(jrs.rs_code(18, 10)), jnp.asarray(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wide", [False, True], ids=["bytes", "packets"])
def test_rs_decode_matches_jax(wide):
    arrays, jarr, cw, mask = _rs_case(18, 10, 8, 8, seed=3, per=0.4)
    recv = cw.masked_fill(mask[:, :, None], 0)
    if not wide:
        cw, recv = cw[:, :, 0], recv[:, :, 0].contiguous()
    got = rs.rs_decode(arrays, recv, mask)
    want = [np.asarray(x) for x in jrs.rs_decode(jarr, jnp.asarray(recv.numpy()),
                                                 jnp.asarray(mask.numpy()))]
    f = got[2].numpy()
    np.testing.assert_array_equal(f, want[2])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy()[~f], want[0][~f])
    np.testing.assert_array_equal(got[0].numpy()[~f], cw.numpy()[~f])
    np.testing.assert_array_equal(f, mask.sum(dim=1).numpy() > 8)
    assert f.any() and not f.all()


@pytest.mark.parametrize("n,k,b,counts", [
    (18, 10, 8, [0, 1, 3, 5, 8, 8, 9, 12]),
    (255, 192, 4, [1, 40, 63, 64]),  # verify_rs: up to n - k solve, n - k + 1 fails
])
def test_rs_decode_wide_matches_jax_and_mds_bound(n, k, b, counts):
    arrays, jarr, cw, mask = _rs_case(n, k, b, 8, seed=n, counts=counts)
    recv = cw.masked_fill(mask[:, :, None], 0)
    got = rs.rs_decode_wide(arrays, recv, mask)
    want = [np.asarray(x) for x in jrs.rs_decode_wide(jarr, jnp.asarray(recv.numpy()),
                                                      jnp.asarray(mask.numpy()))]
    f = got[2].numpy()
    np.testing.assert_array_equal(f, want[2])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy()[~f], want[0][~f])
    report = check_rs(cw, mask, *got, n_minus_k=n - k)
    assert report["ok"], report
    assert report["failed_frames"] == sum(e > n - k for e in counts) > 0
    byte = rs.rs_decode(arrays, recv, mask)  # the byte GE agrees
    np.testing.assert_array_equal(byte[2].numpy(), f)
    np.testing.assert_array_equal(byte[0].numpy()[~f], got[0].numpy()[~f])


def test_check_rs_catches_faults():
    arrays, _, cw, mask = _rs_case(18, 10, 4, 4, seed=7, counts=[2, 8, 9, 4])
    v, e, f = rs.rs_decode_wide(arrays, cw.masked_fill(mask[:, :, None], 0), mask)
    assert check_rs(cw, mask, v, e, f, n_minus_k=8)["ok"]
    bad = v.clone()
    bad[0, 0, 0] ^= 1
    assert check_rs(cw, mask, bad, e, f, n_minus_k=8)["value_mismatches"] == 1
    assert check_rs(cw, mask, v, e, ~f, n_minus_k=8)["failure_flag_mismatches"] == 4
