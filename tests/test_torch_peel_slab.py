"""The two halves of the port's sequential peel kernel (``csrc/peel.cu``),
in their plain versions, against the JAX package's peel, bit-exact.

The kernel splits the decode: a per-frame schedule (the sequential mask
sweep's resolutions, each with a level) and a value pass that applies the
resolutions out of a shared-memory slab. Here ``peel_schedule_reference``
composed with ``apply_schedule_reference`` is held against the Pallas
kernel ``peel_decode_vmem`` in interpret mode (schedule "seq"), the NumPy
oracle and the port's plain ``peel_decode_reference``, on a toy code and
(2040,1530), binary and GF(256), with and without first-k early stop, at
the hybrid's cap of 10 sweeps and at 50; one frame of every batch is not a
codeword. The schedule's levels are checked too: resolutions of one level
write distinct symbols and read only symbols of lower levels. The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes.toy import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem
from ldpc_erasure_codes_tpu.utils import oracle
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import (
    SLAB_WORDS,
    SMEM_LIMIT,
    apply_schedule_reference,
    apply_smem,
    peel_decode_reference,
    peel_schedule_reference,
    schedule_smem,
    slab_words,
)
from torch_port_cases import check_levels

B, W, PER = 8, 8, 0.2

# name -> (JAX code, port code, gf_order)
CODES = {
    "toy": (lambda: jax_toy_code(64, 32), lambda: toy_code(64, 32), 2),
    "toy_gf256": (lambda: jax_toy_code(96, 64, seed=3, gf_order=256),
                  lambda: toy_code(96, 64, seed=3, gf_order=256), 256),
    "n2040_k1530": (lambda: jax_get_code("n2040_k1530"), lambda: get_code("n2040_k1530"), 2),
    "n2040_k1530_gf256": (lambda: jax_get_code("n2040_k1530_gf256"),
                          lambda: get_code("n2040_k1530_gf256"), 256),
}


@functools.cache
def case(name: str):
    """(JAX code, port arrays, codewords (B, n, W) numpy, mask): frame 0
    carries random symbols, not a codeword."""
    make_jax, make_port, gf = CODES[name]
    jcode, code = make_jax(), make_port()
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(len(name))
    if gf == 2:
        src = torch.from_numpy(rng.integers(0, 2**32, (B, code.k, W), dtype=np.uint32)
                               .view(np.int32))
        cw = encode_packed(arrays, src).numpy()
        cw[0] = rng.integers(0, 2**32, cw[0].shape, dtype=np.uint32).view(np.int32)
    else:
        src = torch.from_numpy(rng.integers(0, 256, (B, code.k, 4 * W), dtype=np.uint8))
        cw = encode_packed(arrays, src, gf_order=256).numpy()
        cw[0] = rng.integers(0, 256, cw[0].shape, dtype=np.uint8)
    return jcode, arrays, cw, rng.random((B, code.n)) < PER


def composed(arrays, cw, mask, gf, **kw):
    res, lvl_off, nlev, er, it = peel_schedule_reference(arrays, torch.from_numpy(mask), **kw)
    check_levels(arrays, mask, res.numpy(), lvl_off.numpy(), nlev.numpy())
    v = apply_schedule_reference(arrays, torch.from_numpy(cw), torch.from_numpy(mask), res,
                                 lvl_off, gf_order=gf)
    return v, er, it


@pytest.mark.parametrize("max_iters", [50, 10])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name", CODES)
def test_split_peel_matches_pallas_and_oracle(name, early_stop, max_iters):
    jcode, arrays, cw, mask = case(name)
    gf = CODES[name][2]
    k = jcode.k
    esk = k if early_stop else None
    kw = dict(max_iters=max_iters, early_stop_k=esk)
    got = composed(arrays, cw, mask, gf, **kw)
    plain = peel_decode_reference(arrays, torch.from_numpy(cw), torch.from_numpy(mask),
                                  gf_order=gf, **kw)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    pv, pe, pi = (x.numpy() for x in got)
    jv, je, ji = (np.asarray(x) for x in peel_decode_vmem(
        device_arrays(jcode), jnp.asarray(cw.view(np.uint32) if gf == 2 else cw),
        jnp.asarray(mask), b_tile=8, gf_order=gf, schedule="seq", interpret=True, **kw))
    if gf == 2:
        jv = jv.view(np.int32)
    np.testing.assert_array_equal(pi, ji)
    assert (mask & ~pe).any()  # the peel solved erasures
    if early_stop:  # the TPU stops per tile: first-k mask and resolved values
        np.testing.assert_array_equal(pe[:, :k], je[:, :k])
        both = ~pe & ~je
        np.testing.assert_array_equal(pv[both], jv[both])
    else:
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pv, jv)
        for f in range(B):
            first = cw[f, :, 0].astype(np.int64) & (1 if gf == 2 else 255)
            recv = np.where(mask[f], oracle.ERASED, first)
            peel = oracle.peel_decode if gf == 2 else oracle.peel_decode_nb
            o_out, o_iters = peel(jcode, recv, max_iters=max_iters)
            np.testing.assert_array_equal(pe[f], o_out == oracle.ERASED)
            assert pi[f] == o_iters
            np.testing.assert_array_equal(pv[f, ~pe[f], 0] & (1 if gf == 2 else 255),
                                          o_out[~pe[f]])
    assert not pv[pe].any()
    np.testing.assert_array_equal(pv[~mask], cw[~mask])


def test_schedule_edge_frames():
    """All-erased and none-erased frames, and max_iters=0 (no sweep)."""
    _, arrays, cw, mask = case("n2040_k1530")
    mask = mask.copy()
    mask[1] = True
    mask[2] = False
    res, lvl_off, nlev, er, it = peel_schedule_reference(arrays, torch.from_numpy(mask))
    assert int(lvl_off[1, -1]) == 0 and er[1].all() and int(nlev[1]) == 0
    assert int(lvl_off[2, -1]) == 0 and not er[2].any() and int(it[2]) == 1
    check_levels(arrays, mask, res.numpy(), lvl_off.numpy(), nlev.numpy())
    res, lvl_off, nlev, er, it = peel_schedule_reference(arrays, torch.from_numpy(mask),
                                                         max_iters=0)
    assert not lvl_off.any() and (res == -1).all() and not it.any()
    assert torch.equal(er, torch.from_numpy(mask))


@pytest.mark.parametrize("gf_order", [2, 256])
def test_slab_words_fits_shared_memory(gf_order):
    """Wc is the widest of the kernel's widths that fits a block's shared
    memory and is no wider than W rounded up to 4 words; above the limit
    the wrapper raises."""
    for name in ("n2040_k1530", "n4000_k2000", "n4080_k3060"):
        arrays = code_arrays(get_code(name), "cpu")
        m, dmax = arrays.m, arrays.dmax
        for n, w in ((arrays.n, 256), (arrays.n, 5), (arrays.n, 1), (7000, 256)):
            wc = slab_words(arrays, n, w, gf_order)
            assert wc in SLAB_WORDS and wc <= max(4, -(-w // 4) * 4)
            assert apply_smem(n, m, dmax, wc, gf_order) <= SMEM_LIMIT
            wider = [x for x in SLAB_WORDS if wc < x <= max(4, -(-w // 4) * 4)]
            assert all(apply_smem(n, m, dmax, x, gf_order) > SMEM_LIMIT for x in wider)
            assert schedule_smem(arrays, n) <= SMEM_LIMIT
        assert slab_words(arrays, arrays.n, 1, gf_order) == 4
        with pytest.raises(ValueError, match="shared-memory limit"):
            slab_words(arrays, SMEM_LIMIT // 20, 256, gf_order)
