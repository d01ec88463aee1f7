"""The port's XLA peel variants against the JAX package's, exact.

``peel_decode_jacobi``'s ``impl`` / ``worklist_size`` / ``seq_blocks`` against
JAX's ``peel_decode``; ``peel_decode_wide(split=)``; ``peel_decode_with_history``;
the single sweeps ``peel_step_gather`` and ``peel_step_matmul`` on codewords
and on random frames that are not codewords; and the ``impl`` refusals of
the decoder, the hybrid and the simulation driver, each next to JAX's.
Inputs are made with NumPy from fixed seeds; the JAX side runs on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import sim as jax_sim
from ldpc_erasure_codes_tpu.ops import device_arrays as jax_device_arrays
from ldpc_erasure_codes_tpu.ops import hybrid as jax_hybrid
from ldpc_erasure_codes_tpu.ops import peel as jax_peel
from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_wide as jax_peel_wide
from ldpc_erasure_codes_tpu.sim import driver as jax_driver
from ldpc_erasure_codes_tpu_torch import sim
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import (
    code_arrays,
    encode,
    encode_nb,
    encode_packed,
    hybrid_decode,
    peel_decode_jacobi,
    peel_decode_wide,
    peel_decode_with_history,
    peel_step_gather,
    peel_step_matmul,
    peel_step_seq_blocks,
    peel_step_worklist,
)
from ldpc_erasure_codes_tpu_torch.sim import driver
from ldpc_erasure_codes_tpu_torch.utils import oracle
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words

# (field, W): scalar symbols (W = 0) and wide frames, W words (binary) or
# W bytes (GF(256)).
FRAMES = [(2, 0), (2, 3), (256, 0), (256, 8)]


@functools.cache
def _codes(field: int):
    """(JAX arrays, port arrays, k, m): the small generated code, or its
    seed-0 GF(256) lift on both sides."""
    jcode = small_jax_code()
    code = to_port_code(jcode)
    if field == 256:
        jcode, code = jcode.lift_to_gf256(seed=0), code.lift_to_gf256(seed=0)
    return jax_device_arrays(jcode), code_arrays(code, "cpu"), code.k, code.m


def _frames(field: int, w: int, b: int, per: float, seed: int, codewords: bool = True):
    """(frames, mask, received) in NumPy: codewords, or uniform random
    symbols; ``received`` has the erased slots zeroed."""
    _, arrays, k, _ = _codes(field)
    n = arrays.n
    rng = np.random.default_rng(seed)
    if w == 0:
        x = rng.integers(0, 2 if field == 2 else 256, (b, n), dtype=np.uint8)
        if codewords:
            x = (encode if field == 2 else encode_nb)(arrays, torch.from_numpy(x[:, :k])).numpy()
    elif field == 2:
        x = random_words(rng, (b, n, w))
        if codewords:
            x = to_words(encode_packed(arrays, to_torch(x[:, :k])))
    else:
        x = rng.integers(0, 256, (b, n, w), dtype=np.uint8)
        if codewords:
            src = torch.from_numpy(np.ascontiguousarray(x[:, :k]))
            x = encode_packed(arrays, src, gf_order=256).numpy()
    mask = rng.random((b, n)) < per
    return x, mask, np.where(mask[:, :, None] if w else mask, 0, x)


def _port(x: np.ndarray) -> torch.Tensor:
    return to_torch(x) if x.dtype == np.uint32 else torch.from_numpy(x)


def _np(t: torch.Tensor) -> np.ndarray:
    return to_words(t) if t.dtype == torch.int32 else t.numpy()


def _same(got, want) -> None:
    for g, r in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


@pytest.mark.parametrize("codewords", [True, False], ids=["codewords", "noise"])
@pytest.mark.parametrize("field,w", FRAMES)
def test_single_sweeps_match_jax(field, w, codewords):
    """peel_step_gather, and peel_step_matmul on binary scalars, equal JAX's
    one sweep; on frames that are not codewords the degree-1 checks of a
    symbol disagree and the OR of their values shows."""
    jarr, arrays, _, _ = _codes(field)
    _, mask, recv = _frames(field, w, 16, 0.25, 3 if codewords else 4, codewords)
    want = jax_peel.peel_step_gather(jarr, jnp.asarray(recv), jnp.asarray(mask), field)
    got = peel_step_gather(arrays, _port(recv), torch.from_numpy(mask), field)
    _same(got, want)
    assert (got[1].numpy() != mask).any()
    if field == 2 and w == 0:
        want_mm = jax_peel.peel_step_matmul(jarr, jnp.asarray(recv), jnp.asarray(mask))
        _same(peel_step_matmul(arrays, _port(recv), torch.from_numpy(mask)), want_mm)
        _same(got, want_mm)


@pytest.mark.parametrize("worklist", [4, 16, 128])
@pytest.mark.parametrize("field,w", [(2, 0), (2, 3), (256, 8)])
def test_worklist_matches_jax(field, w, worklist):
    """impl="worklist": values, masks and iteration counts (at 4 checks a
    sweep, where the bound binds and the counts move away from the gather
    decode's, also with first-k stop)."""
    jarr, arrays, k, _ = _codes(field)
    x, mask, recv = _frames(field, w, 16, 0.2, 5)
    for early in (None, k) if worklist == 4 else (None,):
        kw = dict(gf_order=field, max_iters=50, early_stop_k=early)
        want = jax_peel.peel_decode(jarr, jnp.asarray(recv), jnp.asarray(mask), impl="worklist",
                                    worklist_size=worklist, **kw)
        got = peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), impl="worklist",
                                 worklist_size=worklist, **kw)
        _same(got, want)
        gather = peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), **kw)
        np.testing.assert_array_equal(got[1][:, : early or arrays.n].numpy(),
                                      gather[1][:, : early or arrays.n].numpy())
        assert (got[2] != gather[2]).any() == (worklist == 4)
    one = peel_step_worklist(arrays, _port(recv), torch.from_numpy(mask), field, worklist)
    _same(one, jax_peel.peel_step_worklist(jarr, jnp.asarray(recv), jnp.asarray(mask), field,
                                           worklist))


@pytest.mark.parametrize("blocks", [2, 3, "m"])
@pytest.mark.parametrize("field,w", FRAMES)
def test_seq_blocks_matches_jax(field, w, blocks):
    """seq_blocks > 1 wins over impl (JAX's order): the block schedule with
    impl="worklist" equals JAX's (two blocks also with first-k stop); the
    single block step too."""
    jarr, arrays, k, m = _codes(field)
    sb = m if blocks == "m" else blocks
    x, mask, recv = _frames(field, w, 12, 0.2, 6)
    for early in (None, k) if blocks == 2 else (None,):
        kw = dict(gf_order=field, max_iters=50, early_stop_k=early, seq_blocks=sb)
        want = jax_peel.peel_decode(jarr, jnp.asarray(recv), jnp.asarray(mask), **kw)
        _same(peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), **kw), want)
        _same(peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), impl="worklist",
                                 worklist_size=2, **kw), want)
    one = peel_step_seq_blocks(arrays, _port(recv), torch.from_numpy(mask), field, sb)
    _same(one, jax_peel.peel_step_seq_blocks(jarr, jnp.asarray(recv), jnp.asarray(mask), field,
                                             sb))


def test_seq_blocks_m_is_the_oracles_schedule():
    """seq_blocks == m on (2000,1000): each frame's residual and iteration
    count equal the NumPy oracle's MATLAB decoder's, and the fixed point
    equals the Jacobi decode's (JAX's tests/test_encode_peel.py:257-283)."""
    code = get_code("n2000_k1000")
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(0)
    cw = encode(arrays, torch.from_numpy(rng.integers(0, 2, (6, code.k), dtype=np.uint8)))
    mask = torch.from_numpy(rng.random((6, code.n)) < 0.42)
    v, e, iters = peel_decode_jacobi(arrays, cw, mask, max_iters=50, seq_blocks=code.m)
    for i in range(6):
        rv = np.where(mask[i].numpy(), -1, cw[i].numpy().astype(np.int64))
        out, it_o = oracle.peel_decode(code, rv, max_iters=50)
        np.testing.assert_array_equal(e[i].numpy(), out < 0)
        assert int(iters[i]) == it_o
    vj, ej, ij = peel_decode_jacobi(arrays, cw, mask, max_iters=50)
    np.testing.assert_array_equal(ej.numpy(), e.numpy())
    np.testing.assert_array_equal(vj.numpy(), v.numpy())
    assert (iters < ij).any() and e.any() and not e.all()


@pytest.mark.parametrize("split", [1, 2, 3, 4])
@pytest.mark.parametrize("field,w", [(2, 3), (256, 8)])
def test_peel_decode_wide_split_matches_jax(field, w, split):
    """split's blocks are cut at round(i * m / split), not at seq_blocks'
    ceil (m = 16, split 3: checks 0, 5, 11, 16 against 0, 6, 12, 16);
    split 1 equals peel_decode_jacobi; split 2 also with first-k stop."""
    jarr, arrays, k, _ = _codes(field)
    x, mask, recv = _frames(field, w, 12, 0.2, 7)
    for early in (None, k) if split == 2 else (None,):
        kw = dict(gf_order=field, max_iters=50, early_stop_k=early)
        want = jax_peel_wide(jarr, jnp.asarray(recv), jnp.asarray(mask), split=split, **kw)
        got = peel_decode_wide(arrays, _port(x), torch.from_numpy(mask), split=split, **kw)
        _same(got, want)
        if split == 1:
            jacobi = peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), **kw)
            assert all(torch.equal(g, r) for g, r in zip(got, jacobi, strict=True))


def test_split_bounds_round_half_to_even():
    """m = 510, split 4: Python's round gives 0, 128, 255, 382, 510."""
    from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import seq_block_bounds, split_bounds

    assert split_bounds(510, 4) == [0, 128, 255, 382, 510]
    assert seq_block_bounds(510, 4) == [0, 128, 256, 384, 510]
    assert seq_block_bounds(10, 20)[-1] == 10


@pytest.mark.parametrize("impl", ["gather", "matmul", "bogus"])
@pytest.mark.parametrize("field,w", FRAMES)
def test_history_matches_jax(field, w, impl):
    """hist (B, max_iters): the erased count after each of exactly max_iters
    sweeps; "matmul" runs its step on binary scalars and raises elsewhere,
    any other impl runs the gather step, as JAX's."""
    jarr, arrays, _, _ = _codes(field)
    x, mask, recv = _frames(field, w, 12, 0.2, 8)
    if impl == "matmul" and (field, w) != (2, 0):
        with pytest.raises(ValueError):
            peel_decode_with_history(arrays, _port(x), torch.from_numpy(mask), gf_order=field,
                                     impl=impl)
        return
    kw = dict(gf_order=field, max_iters=9, impl=impl)
    want = jax_peel.peel_decode_with_history(jarr, jnp.asarray(recv), jnp.asarray(mask), **kw)
    got = peel_decode_with_history(arrays, _port(x), torch.from_numpy(mask), **kw)
    _same(got, want)
    hist = got[2].numpy()
    assert hist.shape == (12, 9) and hist.dtype == np.int32
    assert (np.diff(hist, axis=1) <= 0).all()
    np.testing.assert_array_equal(hist[:, -1], got[1].sum(dim=1).numpy())


# The Queue 3 cases: (decode, impl, field, W).
REFUSED = [
    ("decoder", "bogus", 2, 3),
    ("decoder", "vmem", 2, 0),
    ("decoder", "matmul", 256, 0),
    ("decoder", "matmul", 2, 3),
    ("sim", "bogus", 2, 0),
    ("sim", "matmul", 256, 0),
    ("hybrid", "matmul", 2, 3),
    ("hybrid", "matmul", 256, 0),
    ("hybrid", "bogus", 256, 8),
]


def _run(decode: str, impl: str, field: int, w: int, jax_side: bool):
    jarr, arrays, k, _ = _codes(field)
    x, mask, recv = _frames(field, w, 8, 0.3, 9)
    if decode == "decoder":
        if jax_side:
            return jax_peel.peel_decode(jarr, jnp.asarray(recv), jnp.asarray(mask),
                                        gf_order=field, impl=impl)
        return peel_decode_jacobi(arrays, _port(x), torch.from_numpy(mask), gf_order=field,
                                  impl=impl)
    if decode == "hybrid":
        if jax_side:
            return jax_hybrid.hybrid_decode(jarr, jnp.asarray(recv), jnp.asarray(mask),
                                            gf_order=field, emax=16, impl=impl)
        return hybrid_decode(arrays, _port(x), torch.from_numpy(mask), gf_order=field, emax=16,
                             impl=impl)
    dec = dict(kind="peel", impl=impl)
    if jax_side:
        cfg = jax_sim.SimConfig(batch=8, gf_order=field, decoder=jax_sim.DecoderConfig(**dec))
        return jax_driver._decode(jarr, cfg, jnp.asarray(recv), jnp.asarray(mask), k)
    cfg = sim.SimConfig(batch=8, gf_order=field, decoder=sim.DecoderConfig(**dec))
    return driver._decode(arrays, cfg, _port(recv), torch.from_numpy(mask), k)


@pytest.mark.parametrize("decode,impl,field,w", REFUSED)
def test_impl_refusals_match_jax(decode, impl, field, w):
    """Where JAX's peel_decode refuses an impl (directly, through the sim's
    peel or through the hybrid's), the port raises ValueError too."""
    with pytest.raises(ValueError):
        _run(decode, impl, field, w, jax_side=True)
    with pytest.raises(ValueError):
        _run(decode, impl, field, w, jax_side=False)


@pytest.mark.parametrize("decode,field,w", [("hybrid", 2, 3), ("hybrid", 256, 0),
                                            ("sim", 2, 0), ("sim", 256, 8)])
def test_worklist_impl_decodes_as_jax(decode, field, w):
    """impl="worklist" in the hybrid and in the sim's peel runs the worklist
    peel, as JAX's: every output equal (the hybrid's failed frames
    excepted from the values)."""
    want = [None if r is None else np.asarray(r) for r in _run(decode, "worklist", field, w, True)]
    got = [None if r is None else _np(r) for r in _run(decode, "worklist", field, w, False)]
    ok = ~want[3] if want[3] is not None else np.ones(len(want[0]), bool)
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    for g, r in zip(got[1:3], want[1:3], strict=True):
        np.testing.assert_array_equal(g, r)
    if decode == "hybrid":
        np.testing.assert_array_equal(got[3], want[3])
