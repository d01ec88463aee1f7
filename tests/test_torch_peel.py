"""The port's peeling decode against the JAX package's, bit-exact.

The JAX side is the Pallas kernel ``peel_decode_vmem`` in interpret mode,
in both production schedules: "seq" (runtime topology) and "unrolled" with
the fence gate (constant topology). The port's wrapper runs its plain
version on CPU tensors (the CUDA kernel is held against it on the card in
tests/test_torch_cuda.py and chip_smoke.py). Without early stop all three
outputs are equal; with ``early_stop_k`` the TPU stops per tile and the port
per frame, so the iteration counts, the first-k mask and every resolved
value are equal (pallas_peel.py:1314-1320), and the parity-region residual
may differ.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem, static_topology
from ldpc_erasure_codes_tpu.utils import oracle
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from torch_port_cases import (
    random_words,
    small_jax_code,
    to_port_code,
    to_torch,
    to_words,
)

B, W = 8, 3


@functools.cache
def small_case(per: float):
    """(codewords uint32, mask) on the small code, from NumPy."""
    jcode = small_jax_code()
    rng = np.random.default_rng(int(per * 1000))
    src = random_words(rng, (B, jcode.k, W))
    arrays = code_arrays(to_port_code(jcode), "cpu")
    cw = to_words(encode_packed(arrays, to_torch(src)))
    return cw, rng.random((B, jcode.n)) < per


def jax_decode(schedule: str, cw, mask, early_stop_k):
    jcode = small_jax_code()
    arrays = device_arrays(jcode)
    kw = dict(schedule=schedule)
    if schedule == "unrolled":
        kw.update(static_topo=static_topology(arrays), fence_gate=True, unroll_blk=4)
    out = peel_decode_vmem(
        arrays, jnp.asarray(cw), jnp.asarray(mask), max_iters=50,
        early_stop_k=early_stop_k, b_tile=4, interpret=True, **kw,
    )
    return [np.asarray(x) for x in out]


def port_decode(cw, mask, early_stop_k):
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    v, e, it = peel_decode(
        arrays, to_torch(cw), torch.from_numpy(mask), max_iters=50, early_stop_k=early_stop_k
    )
    return to_words(v), e.numpy(), it.numpy()


@pytest.mark.parametrize("schedule", ["seq", "unrolled"])
@pytest.mark.parametrize("per", [0.15, 0.25, 0.35])
def test_matches_pallas_peel_small_code(per, schedule):
    cw, mask = small_case(per)
    k = small_jax_code().k
    # Un-erased channel output in: the masking is fused on both sides.
    jv, je, ji = jax_decode(schedule, cw, mask, None)
    pv, pe, pi = port_decode(cw, mask, None)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    # First-k early stop: counts, first-k mask and resolved values.
    jv, je, ji = jax_decode(schedule, cw, mask, k)
    pv, pe, pi = port_decode(cw, mask, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pe[:, :k], je[:, :k])
    both = ~pe & ~je
    np.testing.assert_array_equal(pv[both], jv[both])
    np.testing.assert_array_equal(pv[~pe], cw[~pe])
    assert not pv[pe].any()


def test_matches_oracle_n2040():
    """(2040,1530) at the headline PER, 4 frames: the sequential sweep's
    iteration counts and fixed-point mask equal the NumPy oracle's."""
    jcode = jax_get_code("n2040_k1530")
    rng = np.random.default_rng(5)
    cw = to_words(
        encode_packed(
            code_arrays(get_code("n2040_k1530"), "cpu"),
            to_torch(random_words(rng, (4, jcode.k, 1))),
        )
    )
    mask = rng.random((4, jcode.n)) < 0.1406
    arrays = code_arrays(get_code("n2040_k1530"), "cpu")
    v, e, it = peel_decode(arrays, to_torch(cw), torch.from_numpy(mask), max_iters=50)
    for f in range(4):
        recv = np.where(mask[f], oracle.ERASED, (cw[f, :, 0] & 1).astype(np.int64))
        o_out, o_iters = oracle.peel_decode(jcode, recv, max_iters=50)
        np.testing.assert_array_equal(e[f].numpy(), o_out == oracle.ERASED, err_msg=f"{f}")
        assert int(it[f]) == o_iters, f
    np.testing.assert_array_equal(to_words(v)[~e.numpy()], cw[~e.numpy()])


def test_per_frame_stop_and_iteration_rules():
    """A frame with nothing erased stops after sweep 1; a frame stuck at a
    stopping set reports max_iters; max_iters=0 runs no sweep."""
    cw, mask = small_case(0.25)
    mask = mask.copy()
    mask[0] = False
    pv, pe, pi = port_decode(cw, mask, None)
    assert pi[0] == 1 and not pe[0].any()
    assert (pi[pe.any(axis=1)] == 50).all()
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    v, e, it = peel_decode(arrays, to_torch(cw), torch.from_numpy(mask), max_iters=0)
    np.testing.assert_array_equal(e.numpy(), mask)
    assert (it.numpy() == 0).all()
    assert not to_words(v)[mask].any()


def test_wrapper_validates_and_counts_only_kernel_launches():
    arrays = code_arrays(get_code("n2000_k1000"), "cpu")
    vals = torch.zeros((2, 2000, 2), dtype=torch.int32)
    er = torch.zeros((2, 2000), dtype=torch.bool)
    before = peel_decode.launches
    peel_decode(arrays, vals, er)
    assert peel_decode.launches == before  # CPU tensors take the plain version
    bad = [
        (vals.to(torch.int64), er, {}),
        (vals, er.to(torch.uint8), {}),
        (vals[:, :1999], er[:, :1999], {}),  # shorter than the code
        (vals, er[:1], {}),
        (vals, er, dict(early_stop_k=2001)),
        (vals, er, dict(max_iters=-1)),
        (vals.transpose(1, 2).contiguous().transpose(1, 2), er, {}),
    ]
    for v, e, kw in bad:
        with pytest.raises((TypeError, ValueError)):
            peel_decode(arrays, v, e, **kw)

