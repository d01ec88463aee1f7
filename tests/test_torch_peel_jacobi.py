"""The port's Jacobi decoders, rank checks, scalar encoders and the hybrid's
default ``impl`` against the JAX package, exact.

The JAX side runs its XLA functions on the CPU: ``peel_decode`` with
``impl="gather"`` and ``"matmul"``, ``peel_decode_wide``,
``peel_decode_mask``, ``ge_rank_check``, ``compact_ge_rank``, ``encode``,
``encode_nb`` and ``hybrid_decode`` with its default ``impl="gather"``.
Inputs are made with NumPy from fixed seeds; the frames are codewords, on
which every Jacobi decoder writes the same values.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays, encode as jax_encode
from ldpc_erasure_codes_tpu.ops import encode_nb as jax_encode_nb
from ldpc_erasure_codes_tpu.ops import hybrid as jax_hybrid
from ldpc_erasure_codes_tpu.ops.compact import compact_ge_rank as jax_compact_ge_rank
from ldpc_erasure_codes_tpu.ops.ge import ge_rank_check as jax_ge_rank_check
from ldpc_erasure_codes_tpu.ops.peel import peel_decode as jax_peel
from ldpc_erasure_codes_tpu.ops.peel import peel_decode_mask as jax_peel_mask
from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_wide
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.compact import compact_ge_rank
from ldpc_erasure_codes_tpu_torch.ops.encode import encode, encode_nb, encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi, peel_decode_mask
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words


@functools.cache
def _codes(field: int):
    """(JAX code, JAX arrays, port arrays): the small generated code, or its
    seed-0 GF(256) lift on both sides."""
    jcode = small_jax_code()
    code = to_port_code(jcode)
    if field == 256:
        jcode, code = jcode.lift_to_gf256(seed=0), code.lift_to_gf256(seed=0)
    return jcode, device_arrays(jcode), code_arrays(code, "cpu")


def _frames(field: int, b: int, w: int, per: float, seed: int):
    """(codewords, mask) in NumPy: w == 0 gives scalar uint8 symbols; w > 0
    wide frames, uint32 words (binary) or w bytes (GF(256))."""
    jcode, _, arrays = _codes(field)
    rng = np.random.default_rng(seed)
    if w == 0:
        hi = 2 if field == 2 else 256
        src = torch.from_numpy(rng.integers(0, hi, (b, jcode.k), dtype=np.uint8))
        cw = (encode if field == 2 else encode_nb)(arrays, src).numpy()
    elif field == 2:
        cw = to_words(encode_packed(arrays, to_torch(random_words(rng, (b, jcode.k, w)))))
    else:
        src = torch.from_numpy(rng.integers(0, 256, (b, jcode.k, w), dtype=np.uint8))
        cw = encode_packed(arrays, src, gf_order=256).numpy()
    return cw, rng.random((b, jcode.n)) < per


def _port(cw: np.ndarray) -> torch.Tensor:
    return to_torch(cw) if cw.dtype == np.uint32 else torch.from_numpy(cw)


def _np(t: torch.Tensor) -> np.ndarray:
    return to_words(t) if t.dtype == torch.int32 else t.numpy()


@pytest.mark.parametrize("field,w", [(2, 0), (2, 3), (256, 0), (256, 8)])
@pytest.mark.parametrize("early", [False, True])
def test_peel_decode_jacobi_matches_jax(field, w, early):
    """Values, mask and iteration counts equal JAX's peel_decode (gather;
    matmul too on binary scalars) and, on wide frames, peel_decode_wide."""
    jcode, jarr, arrays = _codes(field)
    for per, seed in ((0.2, 1), (0.4, 2)):
        cw, mask = _frames(field, 12, w, per, seed)
        recv = np.where(mask[:, :, None] if w else mask, 0, cw)
        kw = dict(max_iters=50, early_stop_k=jcode.k if early else None)
        got = [_np(x) for x in peel_decode_jacobi(arrays, _port(cw), torch.from_numpy(mask),
                                                  gf_order=field, **kw)]
        refs = [jax_peel(jarr, jnp.asarray(recv), jnp.asarray(mask), gf_order=field, **kw)]
        if field == 2 and w == 0:
            refs.append(jax_peel(jarr, jnp.asarray(recv), jnp.asarray(mask), impl="matmul", **kw))
        if w:
            refs.append(peel_decode_wide(jarr, jnp.asarray(recv), jnp.asarray(mask),
                                         gf_order=field, **kw))
        for ref in refs:
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, np.asarray(r))
        assert (got[2] > 1).any() and (got[1].any(axis=1) | ~mask.any(axis=1)).any()


def test_peel_decode_jacobi_stop_rules():
    """An erasure-free frame counts 1, a stuck frame max_iters, and the
    batch stops when a sweep clears nothing anywhere."""
    _, jarr, arrays = _codes(2)
    cw, mask = _frames(2, 6, 2, 0.45, 7)
    mask[0] = False
    v, e, it = peel_decode_jacobi(arrays, _port(cw), torch.from_numpy(mask), max_iters=50)
    assert int(it[0]) == 1 and not e[0].any()
    stuck = e.any(dim=1)
    assert stuck.any() and (it[stuck] == 50).all()
    assert not to_words(v)[e.numpy()].any()
    v0, e0, it0 = peel_decode_jacobi(arrays, _port(cw), torch.from_numpy(mask), max_iters=0)
    np.testing.assert_array_equal(e0.numpy(), mask)
    assert (it0.numpy()[mask.any(axis=1)] == 0).all()


@pytest.mark.parametrize("early", [False, True])
def test_peel_decode_mask_matches_jax(early):
    jcode = jax_get_code("n2040_k1530")
    arrays = code_arrays(get_code("n2040_k1530"), "cpu")
    mask = np.random.default_rng(3).random((32, jcode.n)) < 0.19
    kw = dict(max_iters=50, early_stop_k=jcode.k if early else None)
    want = jax_peel_mask(device_arrays(jcode), jnp.asarray(mask), **kw)
    got = peel_decode_mask(arrays, torch.from_numpy(mask), **kw)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].any() and not got[0].all()


@pytest.mark.parametrize("field", [2, 256])
def test_ge_rank_check_and_compact_match_jax(field):
    """Failed flags of the residual after a peel: rank deficiency, emax
    overflow and, compacted, the frame bucket's overflow."""
    jcode, jarr, arrays = _codes(field)
    rng = np.random.default_rng(11)
    mask = rng.random((24, jcode.n)) < 0.45
    mask[:4] = rng.random((4, jcode.n)) < 0.2
    resid = np.array(jax_peel_mask(jarr, jnp.asarray(mask), max_iters=50)[0])
    for emax in (8, 16):
        want = np.asarray(jax_ge_rank_check(jarr, jnp.asarray(resid), emax=emax, gf_order=field))
        got = ge_rank_check(arrays, torch.from_numpy(resid), emax=emax, gf_order=field)
        np.testing.assert_array_equal(got.numpy(), want)
        for f_max in (3, 32):
            want_c = np.asarray(jax_compact_ge_rank(jarr, jnp.asarray(resid), emax=emax,
                                                    f_max=f_max, gf_order=field))
            got_c = compact_ge_rank(arrays, torch.from_numpy(resid), emax=emax, f_max=f_max,
                                    gf_order=field)
            np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert want.any() and not want.all()


@pytest.mark.parametrize("name", ["n2000_k1000", "n2040_k1530_gf256"])
def test_scalar_encoders_match_jax(name):
    jcode, code = jax_get_code(name), get_code(name)
    rng = np.random.default_rng(4)
    hi = 256 if code.gf_order == 256 else 2
    src = rng.integers(0, hi, (2, 3, code.k), dtype=np.uint8)
    fn, jfn = (encode_nb, jax_encode_nb) if hi == 256 else (encode, jax_encode)
    got = fn(code_arrays(code, "cpu"), torch.from_numpy(src))
    assert got.shape == (2, 3, code.n) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(device_arrays(jcode),
                                                              jnp.asarray(src))))


@pytest.mark.parametrize("field,w", [(2, 0), (2, 3), (256, 0), (256, 8)])
@pytest.mark.parametrize("ge_subbatch", [0, 5])
def test_hybrid_default_impl_matches_jax(field, w, ge_subbatch):
    """hybrid_decode's default impl="gather" (JAX's): the Jacobi peel, then
    the GE (scalar symbols through the byte solver). Iteration counts,
    masks, failed and overflow flags, and every non-failed frame."""
    jcode, jarr, arrays = _codes(field)
    cw, mask = _frames(field, 12, w, 0.25, 21)
    recv = np.where(mask[:, :, None] if w else mask, 0, cw)
    kw = dict(gf_order=field, peel_iters=2, emax=12, ge_subbatch=ge_subbatch)
    want = [np.asarray(x) for x in jax_hybrid.hybrid_decode(
        jarr, jnp.asarray(recv), jnp.asarray(mask), return_overflow=True, **kw)]
    got = [_np(x) for x in hybrid_decode(arrays, _port(cw), torch.from_numpy(mask),
                                         return_overflow=True, **kw)]
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, r)
    ok = ~want[3]
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    np.testing.assert_array_equal(got[0][ok], cw[ok])
    assert ok.any() and not ok.all()


def test_hybrid_impl_validation():
    _, _, arrays = _codes(2)
    cw, mask = _frames(2, 2, 2, 0.2, 5)
    with pytest.raises(ValueError):
        hybrid_decode(arrays, _port(cw), torch.from_numpy(mask), impl="xla")
    with pytest.raises(ValueError):
        hybrid_decode(arrays, _port(cw), torch.from_numpy(mask), tiled=True)
