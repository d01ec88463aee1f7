"""The grouped, counted and Jacobi visit orders of the port's peel
schedule kernel (``csrc/peel.cu``), in their plain versions, against the
sequential schedule, the Jacobi decoder and the JAX package's Pallas peel.

On the card, ``peel_decode(schedule="grouped"/"counted"/"jacobi")`` runs
the schedule kernel in that order, then the slab value kernel. Here their
plain halves are held to what they must compute:
``grouped_schedule_reference`` (the check groups visited together) and
``counted_schedule_reference`` (live counts read in windows of 32 checks)
equal ``peel_schedule_reference`` on every output, which checks in plain
code that disjoint checks commute under the sequential sweep and that a
window's ballot order is the sweep's; ``jacobi_schedule_reference`` has one resolution per
symbol per level, at level = its sweep, and composed with
``apply_schedule_reference`` equals ``peel_decode_jacobi_reference`` on
random words (no codeword: where checks solve one symbol in one sweep,
their values differ and the highest-numbered check's is kept); both
composed routes equal ``peel_decode_vmem(schedule=...)`` in interpret mode.
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import (
    apply_schedule_reference,
    counted_schedule_reference,
    grouped_schedule_reference,
    jacobi_schedule_reference,
    peel_decode_reference,
    peel_schedule_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi_reference
from torch_port_cases import (
    check_levels,
    random_words,
    small_jax_code,
    to_port_code,
    to_torch,
    to_words,
    window_cascade,
)

B = 8


@functools.cache
def _arrays(name: str):
    if name == "toy_gf256":
        return code_arrays(toy_code(96, 64, seed=3, gf_order=256), "cpu")
    return code_arrays(get_code(name), "cpu")


def _mask(n: int, per: float, seed: int) -> torch.Tensor:
    """i.i.d. erasures; frame 1 all erased, frame 2 none."""
    mask = torch.from_numpy(np.random.default_rng(seed).random((B, n)) < per)
    mask[1], mask[2] = True, False
    return mask


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("order,per,early_stop,max_iters", [
    pytest.param(order, per, early_stop, max_iters,
                 id=f"{prefix}{per}-{early_stop}-{max_iters}")
    for order, prefix in ((grouped_schedule_reference, ""), (counted_schedule_reference,
                                                              "counted-"))
    for per in (0.1406, 0.3) for early_stop in (False, True) for max_iters in (50, 10)])
def test_grouped_schedule_equals_sequential(order, per, early_stop, max_iters):
    """(2040,1530): the grouped and the counted visits give the
    check-by-check schedule on every output (res, lvl_off, nlev, erased,
    iters), with the all-erased and none-erased frames."""
    arrays = _arrays("n2040_k1530")
    mask = _mask(arrays.n, per, int(per * 1e4))
    kw = dict(max_iters=max_iters, early_stop_k=arrays.n - arrays.m if early_stop else None)
    got = order(arrays, mask, **kw)
    _equal(got, peel_schedule_reference(arrays, mask, **kw))
    assert int(got[1][0, -1]) > 0 and int(got[1][1, -1]) == 0 and int(got[1][2, -1]) == 0


@pytest.mark.parametrize("order", [grouped_schedule_reference, jacobi_schedule_reference,
                                   counted_schedule_reference])
def test_schedule_orders_run_no_sweep_at_zero_iters(order):
    arrays = _arrays("n2040_k1530")
    mask = _mask(arrays.n, 0.1406, 3)
    res, lvl_off, nlev, er, it = order(arrays, mask, max_iters=0)
    assert not lvl_off.any() and (res == -1).all() and not it.any() and not nlev.any()
    assert torch.equal(er, mask)


def test_counted_window_fires_a_check_lowered_in_the_same_sweep():
    """A resolution lowers a later check of the same window from count 2 to
    1: the counted order reads the window again past the check that fired
    and resolves the later one in the same sweep, as the sequential sweep
    does (one sweep, two resolutions, the second one level up)."""
    arrays = _arrays("n2040_k1530")
    e, f, c1, c2 = window_cascade(arrays)
    mask = _mask(arrays.n, 0.1406, 41)
    mask[0] = False
    mask[0, [e, f]] = True
    nbs = arrays.vlist_idx
    assert int((mask[0, nbs[c2, : int(arrays.vlist_len[c2])]]).sum()) == 2
    got = counted_schedule_reference(arrays, mask, max_iters=1)
    _equal(got, peel_schedule_reference(arrays, mask, max_iters=1))
    res, lvl_off, nlev, er, it = got
    slot = [int((nbs[c] == s).nonzero()) for c, s in ((c1, e), (c2, f))]
    assert res[0, :2].tolist() == [c1 << 8 | slot[0], c2 << 8 | slot[1]]
    assert lvl_off[0, :3].tolist() == [0, 1, 2] and int(nlev[0]) == 2
    assert not er[0].any() and int(it[0]) == 1


def _cleared_at(arrays, mask, words, max_iters, early_stop_k):
    """The sweep after which the Jacobi decoder first has each symbol known
    (0: known on input, max_iters + 1: never)."""
    sweep = torch.where(mask, max_iters + 1, 0)
    for t in range(1, max_iters + 1):
        er = peel_decode_jacobi_reference(arrays, words, mask, max_iters=t,
                                          early_stop_k=early_stop_k)[1]
        sweep = torch.where((sweep > t) & ~er, t, sweep)
    return sweep


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name,per", [("n2040_k1530", 0.1406), ("n2040_k1530", 0.3),
                                      ("n4000_k2000", 0.3)])
def test_jacobi_schedule_levels_are_sweeps(name, per, early_stop):
    """One resolution per symbol per level, each reading lower levels only
    (``check_levels``), at level = the sweep in which the Jacobi decoder
    clears its symbol; erased flags and counts are the decoder's."""
    arrays = _arrays(name)
    mask = _mask(arrays.n, per, 11)
    esk = arrays.n - arrays.m if early_stop else None
    res, lvl_off, nlev, er, it = jacobi_schedule_reference(arrays, mask, early_stop_k=esk)
    check_levels(arrays, mask.numpy(), res.numpy(), lvl_off.numpy(), nlev.numpy())
    words = torch.zeros((B, arrays.n, 1), dtype=torch.int32)
    _, want_er, want_it = peel_decode_jacobi_reference(arrays, words, mask, early_stop_k=esk)
    assert torch.equal(er, want_er) and torch.equal(it, want_it)
    cleared = _cleared_at(arrays, mask, words, int(nlev.max()), esk)
    vidx = arrays.vlist_idx
    for f in range(B):
        for lv in range(1, int(nlev[f]) + 1):
            t = res[f, lvl_off[f, lv - 1]:lvl_off[f, lv]]
            syms = vidx[t >> 8, t & 255]
            assert (cleared[f, syms] == lv).all()
            assert torch.equal(t, t.sort().values)  # check order within a level
        assert int((cleared[f] >= 1).sum() - (cleared[f] > nlev[f]).sum()) == int(lvl_off[f, -1])


def _random_input(arrays, gf_order: int, seed: int) -> torch.Tensor:
    """Random words (binary int32, GF(256) uint8 bytes), no codeword."""
    rng = np.random.default_rng(seed)
    if gf_order == 2:
        return to_torch(random_words(rng, (B, arrays.n, 3)))
    return torch.from_numpy(rng.integers(0, 256, (B, arrays.n, 12), dtype=np.uint8))


def _single_erasures(arrays, mask):
    """Frames 3..7 erase one symbol of column degree >= 2 alone: all its
    checks solve it in the first sweep."""
    syms = (arrays.clist_len >= 2).nonzero().squeeze(1)
    picked = []
    for f in range(3, B):
        e = int(syms[(37 * f) % len(syms)])
        mask[f] = False
        mask[f, e] = True
        picked.append((f, e))
    return mask, picked


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name,gf_order", [("n2040_k1530", 2), ("n2040_k1530_gf256", 256),
                                           ("toy_gf256", 256)])
def test_jacobi_route_matches_decoder_on_random_words(name, gf_order, early_stop):
    """The Jacobi schedule composed with the value pass equals the plain
    Jacobi decoder on every output, on random words; a symbol that several
    checks solve at once takes the highest-numbered check's value, which
    differs from the others' here."""
    arrays = _arrays(name)
    mask, picked = _single_erasures(arrays, _mask(arrays.n, 0.1406, 29))
    words = _random_input(arrays, gf_order, 31)
    esk = arrays.n - arrays.m if early_stop else None
    res, lvl_off, nlev, er, it = jacobi_schedule_reference(arrays, mask, early_stop_k=esk)
    got = apply_schedule_reference(arrays, words, mask, res, lvl_off, gf_order=gf_order)
    want = peel_decode_jacobi_reference(arrays, words, mask, early_stop_k=esk,
                                        gf_order=gf_order)
    _equal((got, er, it), want)
    for f, e in picked:
        checks = arrays.clist_idx[e, : int(arrays.clist_len[e])]
        assert int(lvl_off[f, -1]) == 1 and int(res[f, 0]) >> 8 == int(checks.max())
        one = torch.zeros_like(mask[:1])
        one[0, e] = True
        sums = []
        for c in checks.tolist():  # each check's own solution of e
            es = int((arrays.vlist_idx[c] == e).nonzero())
            t = torch.tensor([[c << 8 | es]], dtype=torch.int32)
            off = torch.ones((1, arrays.n + 1), dtype=torch.int32)
            off[0, 0] = 0
            sums.append(apply_schedule_reference(arrays, words[f:f + 1], one, t, off,
                                                 gf_order=gf_order)[0, e])
        assert torch.equal(got[f, e], sums[-1]) and not torch.equal(sums[0], sums[-1])


@functools.cache
def _small_case(per: float):
    jcode = small_jax_code()
    rng = np.random.default_rng(int(per * 1000) + 7)
    arrays = code_arrays(to_port_code(jcode), "cpu")
    cw = to_words(encode_packed(arrays, to_torch(random_words(rng, (B, jcode.k, 3)))))
    cw[0] = random_words(rng, cw[0].shape)  # frame 0 is not a codeword
    return jcode, arrays, cw, rng.random((B, jcode.n)) < per


_ORDERS = {"grouped": grouped_schedule_reference, "jacobi": jacobi_schedule_reference,
           "counted": counted_schedule_reference}


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("schedule", ["grouped", "jacobi", "counted"])
def test_composed_routes_match_pallas_kernel(schedule, early):
    """Schedule then value pass against ``peel_decode_vmem`` in interpret
    mode on the small code. One-frame tiles stop per frame, as the port
    does, so "jacobi" (b_tile=1) is compared whole; "grouped" and "counted"
    (4-frame tiles) whole without early stop, and with it on the counts,
    the first-k mask and the resolved values."""
    jcode, arrays, cw, mask = _small_case(0.3)
    k = jcode.k
    esk = k if early else None
    bt = 1 if schedule == "jacobi" else 4
    order = _ORDERS[schedule]
    res, lvl_off, nlev, er, it = order(arrays, torch.from_numpy(mask), early_stop_k=esk)
    check_levels(arrays, mask, res.numpy(), lvl_off.numpy(), nlev.numpy())
    v = to_words(apply_schedule_reference(arrays, to_torch(cw), torch.from_numpy(mask), res,
                                          lvl_off))
    er, it = er.numpy(), it.numpy()
    jv, je, ji = (np.asarray(x) for x in peel_decode_vmem(
        device_arrays(jcode), jnp.asarray(cw), jnp.asarray(mask), max_iters=50,
        early_stop_k=esk, b_tile=bt, schedule=schedule, interpret=True))
    np.testing.assert_array_equal(it, ji)
    np.testing.assert_array_equal(er[:, :k], je[:, :k])
    both = ~er & ~je
    np.testing.assert_array_equal(v[both], jv[both])
    assert (mask & ~er).any()
    if not early or bt == 1:
        np.testing.assert_array_equal(er, je)
        np.testing.assert_array_equal(v, jv)
    plain = (peel_decode_jacobi_reference if schedule == "jacobi" else peel_decode_reference)(
        arrays, to_torch(cw), torch.from_numpy(mask), early_stop_k=esk)
    np.testing.assert_array_equal(v, to_words(plain[0]))
