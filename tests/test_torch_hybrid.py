"""The port's hybrid decoder (peel, then the compacted GE) against the JAX
package's, on the CPU, and against the NumPy MATLAB-semantics oracle.

The JAX side runs its production wide path, ``impl="vmem"`` with the
tile-major layout (the peel kernel in interpret mode). At (2040,1530) it
runs the "seq" peel schedule: the unrolled ``static_topo`` program takes
minutes to build there in interpret mode, and both schedules compute one
function (tests/test_pallas_peel.py); the unrolled program is exercised on
the small generated code. Failed frames' values are garbage on both sides
and are compared only where the frame did not fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import hybrid as jax_hybrid
from ldpc_erasure_codes_tpu.ops.pallas_peel import static_topology, tile_wide, untile_wide
from ldpc_erasure_codes_tpu.utils import oracle
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.utils.verify import check_hybrid, replay_residual
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words


def _case(port_code, jcode, b, w, per, seed):
    """(port arrays, JAX arrays, codewords, mask): codewords from the port's
    encoder (equal to the JAX package's, tests/test_torch_encode.py)."""
    arrays = code_arrays(port_code, "cpu")
    rng = np.random.default_rng(seed)
    cw = encode_packed(arrays, to_torch(random_words(rng, (b, port_code.k, w))))
    mask = rng.random((b, port_code.n)) < per
    return arrays, device_arrays(jcode), cw, mask


def _jax_tiled(jarr, cw, mask, bt, **kw):
    """JAX production hybrid on the tile-major layout; flat outputs."""
    b, n = mask.shape
    recv = np.where(mask[:, :, None], 0, to_words(cw))
    v, e, it, f, ov = jax_hybrid.hybrid_decode(
        jarr, tile_wide(jnp.asarray(recv), bt), jnp.asarray(mask), impl="vmem",
        b_tile=bt, tiled=True, return_overflow=True, **kw,
    )
    return np.asarray(untile_wide(v, b, n)), *(np.asarray(x) for x in (e, it, f, ov))


def _assert_same(got, want, cw):
    v, e, it, f, ov = got
    jv, je, jit, jf, jov = want
    np.testing.assert_array_equal(f.numpy(), jf)
    np.testing.assert_array_equal(ov.numpy(), jov)
    np.testing.assert_array_equal(it.numpy(), jit)
    np.testing.assert_array_equal(e.numpy(), je)
    ok = ~jf
    np.testing.assert_array_equal(to_words(v)[ok], jv[ok])
    np.testing.assert_array_equal(to_words(v)[ok], to_words(cw)[ok])


@pytest.fixture(scope="module")
def case2040():
    return _case(get_code("n2040_k1530"), jax_get_code("n2040_k1530"), 16, 8, 0.19, 0)


@pytest.mark.parametrize("emax,ge_subbatch", [(256, 8), (128, 4)])
def test_hybrid_matches_jax_2040(case2040, emax, ge_subbatch):
    """(2040,1530), B=16, W=8, PER .19 (tests/test_compact.py:80-116). With
    emax 128 and a bucket of 4 frames, frames also fail by overflow."""
    arrays, jarr, cw, mask = case2040
    kw = dict(peel_iters=10, emax=emax, ge_subbatch=ge_subbatch)
    want = _jax_tiled(jarr, cw, mask, 4, **kw)
    m = torch.from_numpy(mask)
    assert peel_decode(arrays, cw, m, max_iters=10)[1].any()  # the GE has work
    assert (ge_subbatch == 8) == (not want[4].any())
    for tiled in (True, False):  # row writeback (topology syndrome) / compact_ge_solve
        got = hybrid_decode(arrays, cw, m, tiled=tiled, static_topo=True, return_overflow=True,
                            impl="vmem", **kw)
        _assert_same(got, want, cw)


def test_hybrid_matches_jax_unrolled_small():
    """The JAX production configuration (unrolled static_topo peel,
    tile-direct GE with the topology syndrome) on the small code."""
    jcode = small_jax_code()
    arrays, jarr, cw, mask = _case(to_port_code(jcode), jcode, 16, 3, 0.3, 5)
    kw = dict(peel_iters=10, emax=16, ge_subbatch=8)
    want = _jax_tiled(jarr, cw, mask, 4, static_topo=static_topology(jarr), **kw)
    assert want[3].any() and not want[3].all()
    got = hybrid_decode(arrays, cw, torch.from_numpy(mask), tiled=True, static_topo=True,
                        return_overflow=True, impl="vmem", **kw)
    _assert_same(got, want, cw)


@pytest.mark.parametrize("ge_subbatch", [0, 1])
def test_escalation_matches_jax(ge_subbatch):
    """tests/test_ge_hybrid.py:264-313: emax 64 (or a bucket of one frame)
    overflows every frame at PER .42 on (2000,1000); escalation re-solves."""
    arrays, jarr, cw, mask = _case(
        get_code("n2000_k1000"), jax_get_code("n2000_k1000"), 4, 2, 0.42, 5
    )
    emax = 64 if ge_subbatch == 0 else 512
    recv = np.where(mask[:, :, None], 0, to_words(cw))
    jv, je, jit, jf, jn = jax_hybrid.hybrid_decode_escalated(
        jarr, jnp.asarray(recv), jnp.asarray(mask), peel_iters=10, emax=emax, impl="vmem",
        b_tile=4, ge_subbatch=ge_subbatch,
    )
    m = torch.from_numpy(mask)
    first = hybrid_decode(arrays, cw, m, peel_iters=10, emax=emax, ge_subbatch=ge_subbatch,
                          impl="vmem")
    v, e, it, f, n_esc = hybrid_decode_escalated(
        arrays, cw, m, peel_iters=10, emax=emax, ge_subbatch=ge_subbatch, impl="vmem"
    )
    assert n_esc == jn and n_esc > 0
    assert first[3].sum() > f.sum()  # escalation recovered frames
    _assert_same((v, e, it, f, f), tuple(np.asarray(x) for x in (jv, je, jit, jf, jf)), cw)


def test_hybrid_matches_oracle():
    """Second judge: utils/oracle.py::hybrid_ml_decode (MATLAB semantics,
    row swaps) on one-bit symbols; emax = n, so failed == singular."""
    jcode = jax_get_code("n2040_k1530")
    arrays = code_arrays(get_code("n2040_k1530"), "cpu")
    rng = np.random.default_rng(8)
    src = rng.integers(0, 2, (6, jcode.k, 1)).astype(np.uint32)
    cw = encode_packed(arrays, to_torch(src))
    mask = rng.random((6, jcode.n)) < 0.205
    v, e, it, f = hybrid_decode(arrays, cw, torch.from_numpy(mask), emax=jcode.n, impl="vmem")
    bits = to_words(cw)[:, :, 0].astype(np.int64)
    n_ge = 0
    for i in range(6):
        y, iters, singular = oracle.hybrid_ml_decode(
            jcode, np.where(mask[i], oracle.ERASED, bits[i]), peel_iters=10
        )
        assert bool(f[i]) == singular
        assert int(it[i]) == iters
        if not singular:
            np.testing.assert_array_equal(to_words(v)[i, :, 0], y)
        n_ge += int(peel_decode(arrays, cw[i : i + 1], torch.from_numpy(mask[i : i + 1]),
                                max_iters=10)[1].any())
    assert n_ge > 0 and not f.all()


def test_check_hybrid_catches_each_fault(case2040):
    arrays, _, cw, mask = case2040
    m = torch.from_numpy(mask)
    v, e, _, f = hybrid_decode(arrays, cw, m, emax=256, ge_subbatch=8, tiled=True,
                               static_topo=True, impl="vmem")
    report = check_hybrid(arrays, cw, m, v, e, f, peel_iters=10)
    stuck = peel_decode(arrays, cw, m, max_iters=10)[1].any(dim=1)
    assert report["ok"], report
    assert report["ge_frames"] == int(stuck.sum()) > 0
    np.testing.assert_array_equal(replay_residual(arrays, m, 10), stuck.numpy())
    solved = int(torch.nonzero(stuck & ~f)[0])
    bad_v = v.clone()
    bad_v[solved, 3, 1] ^= 1
    assert check_hybrid(arrays, cw, m, bad_v, e, f, peel_iters=10)["value_mismatches"] == 1
    bad_e = e.clone()
    bad_e[solved, 3] = True
    assert check_hybrid(arrays, cw, m, v, bad_e, f, peel_iters=10)["residual_on_solved"] == 1
    got = check_hybrid(arrays, cw, m, v, e, torch.ones_like(f), peel_iters=10)
    assert not got["ok"] and got["failed_frames"] == 16
    assert not check_hybrid(arrays, cw, torch.zeros_like(m), v, e, f, peel_iters=10)["ok"]
    assert check_hybrid(arrays, cw, torch.zeros_like(m), v, e, f, peel_iters=10,
                        require_ge=False)["ok"]
