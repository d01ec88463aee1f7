"""The research peel schedules ("counted", "grouped", "jacobi") and the code
tables they read, on the CPU, against the JAX package.

On CPU tensors ``peel_decode(schedule=...)`` runs the kernels' plain
versions: the sequential decode for "counted" and "grouped" (their kernels
compute the "seq" function, tests/test_pallas_peel.py:71-98, :288-307),
``peel_decode_jacobi_reference`` for "jacobi". The JAX side is the Pallas
kernel ``peel_decode_vmem`` in interpret mode and the NumPy oracle; the
CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.arrays import _host_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem
from ldpc_erasure_codes_tpu.utils import oracle
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, host_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import SCHEDULES, peel_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    peel_decode_jacobi,
    peel_decode_jacobi_reference,
)
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words

NEW_FIELDS = ("clist_idx", "clist_len", "check_groups")


@pytest.mark.parametrize("lift", [False, True])
def test_new_fields_match_host_arrays(lift):
    jcode, code = small_jax_code(), to_port_code(small_jax_code())
    if lift:
        jcode, code = jcode.lift_to_gf256(seed=0), code.lift_to_gf256(seed=0)
    ref, ours = _host_arrays(jcode), host_arrays(code)
    arrays = code_arrays(code, "cpu")
    for f in NEW_FIELDS:
        assert ours[f].dtype == np.int32 == ref[f].dtype, f
        np.testing.assert_array_equal(ours[f], ref[f], err_msg=f)
        np.testing.assert_array_equal(getattr(arrays, f).numpy(), ref[f], err_msg=f)
    groups = ours["check_groups"]
    assert (groups[:, 0] < code.m).all() and groups.max() == code.m  # pad = m
    with pytest.raises(ValueError):
        from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays_from_numpy

        code_arrays_from_numpy(dict(ours, clist_len=ours["clist_len"] + 1), "cpu")


@functools.cache
def _small_case(per: float, b: int = 8, w: int = 3):
    jcode = small_jax_code()
    rng = np.random.default_rng(int(per * 1000) + 1)
    arrays = code_arrays(to_port_code(jcode), "cpu")
    cw = to_words(encode_packed(arrays, to_torch(random_words(rng, (b, jcode.k, w)))))
    return cw, rng.random((b, jcode.n)) < per


def _port(schedule, cw, mask, **kw):
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    out = peel_decode(arrays, to_torch(cw), torch.from_numpy(mask), schedule=schedule,
                      max_iters=50, **kw)
    return to_words(out[0]), out[1].numpy(), out[2].numpy()


@pytest.mark.parametrize("schedule", ["counted", "grouped"])
def test_sequential_schedules_match_oracle_n2040(schedule):
    """(2040,1530) at the headline PER: "counted" and "grouped" give the
    NumPy oracle's (MATLAB order) iteration counts and fixed point."""
    jcode = jax_get_code("n2040_k1530")
    arrays = code_arrays(get_code("n2040_k1530"), "cpu")
    rng = np.random.default_rng(6)
    cw = encode_packed(arrays, to_torch(random_words(rng, (3, jcode.k, 1))))
    mask = rng.random((3, jcode.n)) < 0.1406
    v, e, it = peel_decode(arrays, cw, torch.from_numpy(mask), max_iters=50, schedule=schedule)
    bits = to_words(cw)[:, :, 0] & 1
    for f in range(3):
        recv = np.where(mask[f], oracle.ERASED, bits[f].astype(np.int64))
        o_out, o_iters = oracle.peel_decode(jcode, recv, max_iters=50)
        np.testing.assert_array_equal(e[f].numpy(), o_out == oracle.ERASED)
        assert int(it[f]) == o_iters
    np.testing.assert_array_equal(to_words(v)[~e.numpy()], to_words(cw)[~e.numpy()])


@pytest.mark.parametrize("per", [0.2, 0.35])
def test_schedules_match_pallas_kernel(per):
    """Each schedule against ``peel_decode_vmem(schedule=...)`` in interpret
    mode on the small code: without early stop all outputs; with it the
    iteration counts, the first-k mask and the resolved values (the TPU
    kernel stops per tile, the port per frame). One-frame tiles stop per
    frame, so "jacobi" is compared whole there."""
    jcode = small_jax_code()
    cw, mask = _small_case(per)
    k = jcode.k
    jarr = device_arrays(jcode)
    for schedule in ("counted", "grouped", "jacobi"):
        for early in (None, k):
            bt = 1 if schedule == "jacobi" else 4
            want = [np.asarray(x) for x in peel_decode_vmem(
                jarr, jnp.asarray(cw), jnp.asarray(mask), max_iters=50, early_stop_k=early,
                b_tile=bt, schedule=schedule, interpret=True)]
            got = _port(schedule, cw, mask, early_stop_k=early)
            np.testing.assert_array_equal(got[2], want[2], err_msg=f"{schedule} {early}")
            np.testing.assert_array_equal(got[1][:, :k], want[1][:, :k])
            both = ~got[1] & ~want[1]
            np.testing.assert_array_equal(got[0][both], want[0][both])
            np.testing.assert_array_equal(got[0][~got[1]], cw[~got[1]])
            if early is None or bt == 1:
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("early", [False, True])
def test_jacobi_reference_against_jacobi_decoder(early):
    """The kernel's plain version stops per frame: without early stop it
    equals the Jacobi decoder; with it, on the counts, the first-k mask and
    every resolved value."""
    jcode = small_jax_code()
    arrays = code_arrays(to_port_code(jcode), "cpu")
    cw, mask = _small_case(0.3, b=16)
    k = jcode.k if early else None
    ref = peel_decode_jacobi_reference(arrays, to_torch(cw), torch.from_numpy(mask),
                                       early_stop_k=k)
    dec = peel_decode_jacobi(arrays, to_torch(cw), torch.from_numpy(mask), early_stop_k=k)
    assert torch.equal(ref[2], dec[2]) and (ref[2] > 1).any()
    kk = jcode.k if early else jcode.n
    assert torch.equal(ref[1][:, :kk], dec[1][:, :kk])
    both = ~ref[1] & ~dec[1]
    assert torch.equal(ref[0][both], dec[0][both])
    if not early:
        assert torch.equal(ref[0], dec[0]) and torch.equal(ref[1], dec[1])


def test_schedule_validation_and_counters():
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    cw, mask = _small_case(0.2)
    counts = {s: getattr(peel_decode, f"launches_{s}") for s in ("counted", "grouped", "jacobi")}
    for s in SCHEDULES:
        peel_decode(arrays, to_torch(cw), torch.from_numpy(mask), schedule=s)
    # CPU tensors take the plain versions; only kernel launches count.
    assert counts == {s: getattr(peel_decode, f"launches_{s}") for s in counts}
    with pytest.raises(ValueError):
        peel_decode(arrays, to_torch(cw), torch.from_numpy(mask), schedule="serpentine")
