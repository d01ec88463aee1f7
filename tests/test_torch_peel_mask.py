"""The pattern-only peel's kernel route on the CPU: its stop rule, its plain
route and the simulation's histogram.

``csrc/peel_mask.cu`` rebuilds the JAX loop's batch-wide stop from two
per-frame quantities (the sweep after which a frame's first k symbols are
known, and the sweep after which its mask stops changing), on 32 frames
bit-sliced into one word per symbol. :func:`kernel_model` is that algorithm
in NumPy, word for word; it is held here to the plain route that the CPU
takes (and that JAX's test holds, ``test_torch_peel_jacobi.py``). The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    batch_loop,
    mask_sweep,
    peel_decode_jacobi_reference,
    peel_decode_mask,
    peel_decode_mask_reference,
)
from ldpc_erasure_codes_tpu_torch.sim.stats import batch_stats

FULL = np.uint32(0xFFFFFFFF)


def _bits(word: np.ndarray) -> np.ndarray:
    """(G,) uint32 -> (G, 32) bool, bit l of group g at [g, l]."""
    return ((word[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)


def kernel_model(arrays, erased: np.ndarray, k_stop: int, max_iters: int):
    """The kernel's algorithm in NumPy: (residual (B, n) bool, iters (B,)
    int32, T). Launch 1 sweeps each group's words until every frame is at
    its fixed point or ``max_iters`` (S_g sweeps), noting d (first sweep with
    the first k_stop known; 0 if none lost; max_iters + 1 if never) and c
    (first t with M(t + 1) = M(t), capped at max_iters); launch 2 sweeps the
    group's first words again min(T, S_g) times, T = min(max_iters, max d,
    max c + 1). Groups are swept together here: a group at its fixed point
    does not change."""
    b, n = erased.shape
    m, dmax = arrays.m, arrays.dmax
    cmax = arrays.clist_idx.shape[1]
    g = -(-b // 32)
    rows = np.zeros((g * 32, n), dtype=np.uint32)
    rows[:b] = erased
    packed = np.zeros((g, n + 1), dtype=np.uint32)  # column n: the zero pad
    packed[:, :n] = (rows.reshape(g, 32, n) << np.arange(32, dtype=np.uint32)[None, :, None]).sum(
        axis=1, dtype=np.uint32)
    vlen, clen = arrays.vlist_len.numpy(), arrays.clist_len.numpy()
    vl = np.where(np.arange(dmax) < vlen[:, None], arrays.vlist_idx.numpy(), n)
    cl = np.where(np.arange(cmax) < clen[:, None], arrays.clist_idx.numpy(), m)

    def sweep(w):
        ones = np.zeros((g, m), dtype=np.uint32)
        twos = np.zeros_like(ones)
        for t in range(dmax):
            x = w[:, vl[:, t]]
            twos |= ones & x
            ones |= x
        one = np.concatenate([ones & ~twos, np.zeros((g, 1), dtype=np.uint32)], axis=1)
        hit = np.zeros((g, n), dtype=np.uint32)
        for t in range(cmax):
            hit |= one[:, cl[:, t]]
        out = w.copy()
        out[:, :n] &= ~hit
        return out

    states = [packed]  # the words after each sweep
    left = np.bitwise_or.reduce(packed[:, :k_stop], axis=1) if k_stop else np.zeros(g, np.uint32)
    d = np.where(_bits(left), max_iters + 1, 0)
    c = np.full((g, 32), max_iters)
    fixed = np.zeros(g, dtype=np.uint32)
    s_g = np.zeros(g, dtype=np.int64)  # launch 1's sweeps, per group
    for s in range(1, max_iters + 1):
        if (fixed == FULL).all():
            break
        s_g[fixed != FULL] = s
        new = sweep(states[-1])
        chg = np.bitwise_or.reduce(states[-1] ^ new, axis=1)
        still = (np.bitwise_or.reduce(new[:, :k_stop], axis=1) if k_stop
                 else np.zeros(g, np.uint32))
        d[_bits(left & ~still)] = s
        c[_bits(~fixed & ~chg)] = s - 1
        left, fixed = still, fixed | ~chg
        states.append(new)
    d, c = d.reshape(-1)[:b], c.reshape(-1)[:b]
    t_stop = min(max_iters, int(d.max()), int(c.max()) + 1)
    w = np.stack([states[min(s_g[i], t_stop)][i] for i in range(g)])
    residual = ((w[:, None, :n] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1).astype(bool)
    iters = np.where(d == 0, 1, np.minimum(d, max_iters)).astype(np.int32)
    return residual.reshape(g * 32, n)[:b], iters, t_stop


@pytest.fixture(scope="module")
def arrays_2040():
    return code_arrays(get_code("n2040_k1530"), "cpu")


# (b, per, max_iters, early, how the plain loop stops: "done", "stall", "cap"
# or None where any may)
STOP_CASES = [
    (96, 0.1875, 50, True, None),
    (96, 0.1875, 50, False, None),
    (1, 0.1875, 50, True, None),
    (31, 0.1875, 50, True, None),
    (33, 0.1875, 50, True, None),
    (64, 0.1875, 0, True, "cap"),
    (64, 0.1875, 1, True, "cap"),
    (64, 0.1875, 2, True, "cap"),
    (64, 0.1875, 5, True, "cap"),
    (64, 0.1875, 200, False, None),
    (64, 0.05, 50, True, "done"),
    (64, 0.3, 50, True, "stall"),
]


@pytest.mark.parametrize("b,per,max_iters,early,stop", STOP_CASES)
def test_kernel_model_equals_the_plain_loop(arrays_2040, b, per, max_iters, early, stop):
    """The per-frame rebuild of the batch-wide stop gives the plain loop's
    residual and counts bit for bit, and its T is the loop's sweeps."""
    k = 1530 if early else 2040
    mask = np.random.default_rng(b * 1000 + max_iters).random((b, 2040)) < per
    e, it = peel_decode_mask(arrays_2040, torch.from_numpy(mask), max_iters=max_iters,
                             early_stop_k=k if early else None)
    got_e, got_it, t_stop = kernel_model(arrays_2040, mask, k, max_iters)
    np.testing.assert_array_equal(got_e, e.numpy())
    np.testing.assert_array_equal(got_it, it.numpy())
    sweeps = []

    def counted(v, er):
        sweeps.append(1)
        return v, mask_sweep(arrays_2040, er)

    erased = torch.from_numpy(mask)
    batch_loop(counted, erased, erased, max_iters=max_iters, k_stop=k)
    assert t_stop == len(sweeps)
    if stop == "cap":
        assert t_stop == max_iters
    elif stop == "done":
        assert t_stop < max_iters and not e[:, :k].any()
    elif stop == "stall":
        assert t_stop < max_iters and e[:, :k].any()


@pytest.mark.parametrize("n,k,b,per", [(50, 33, 40, 0.2), (101, 60, 70, 0.3)])
def test_kernel_model_on_ragged_codes(n, k, b, per):
    """Small toy codes, one whose n is no multiple of 4: the rebuild of the
    stop does not depend on the code (the kernel itself takes n a multiple
    of 4, and the card's wrapper refuses the rest)."""
    arrays = code_arrays(toy_code(n=n, k=k, seed=n), "cpu")
    mask = np.random.default_rng(n).random((b, n)) < per
    for early in (k, None):
        e, it = peel_decode_mask(arrays, torch.from_numpy(mask), max_iters=20, early_stop_k=early)
        got_e, got_it, _ = kernel_model(arrays, mask, n if early is None else early, 20)
        np.testing.assert_array_equal(got_e, e.numpy())
        np.testing.assert_array_equal(got_it, it.numpy())


def test_batch_stop_differs_from_the_per_frame_stop(arrays_2040):
    """With a first-k stop the batch's residual is not the per-frame stop's
    (done frames sweep on): the kernel has to keep the batch's."""
    mask = torch.from_numpy(np.random.default_rng(5).random((96, 2040)) < 0.1875)
    e, it = peel_decode_mask(arrays_2040, mask, max_iters=50, early_stop_k=1530)
    words = torch.zeros((96, 2040, 1), dtype=torch.int32)
    _, e_frame, it_frame = peel_decode_jacobi_reference(arrays_2040, words, mask, max_iters=50,
                                                        early_stop_k=1530)
    torch.testing.assert_close(it, it_frame, rtol=0, atol=0)
    torch.testing.assert_close(e[:, :1530], e_frame[:, :1530], rtol=0, atol=0)
    assert int(e.sum()) < int(e_frame.sum())


def test_cpu_tensors_take_the_plain_route(arrays_2040):
    mask = torch.from_numpy(np.random.default_rng(6).random((40, 2040)) < 0.2)
    before = peel_decode_mask.launches
    got = peel_decode_mask(arrays_2040, mask, max_iters=50, early_stop_k=1530)
    want = peel_decode_mask_reference(arrays_2040, mask, max_iters=50, early_stop_k=1530)
    assert peel_decode_mask.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(max_iters=-1), dict(early_stop_k=2041),
                                dict(early_stop_k=-1)])
def test_peel_decode_mask_refusals(arrays_2040, kw):
    with pytest.raises(ValueError):
        peel_decode_mask(arrays_2040, torch.zeros((2, 2040), dtype=torch.bool), **kw)


@pytest.mark.parametrize("max_iters", [0, 5, 50])
def test_batch_stats_histogram_equals_bincount(max_iters):
    """The sync-free histogram counts what ``torch.bincount`` does, counts
    outside 0..max_iters in the end bins."""
    g = torch.Generator().manual_seed(max_iters)
    iters = torch.randint(-4, max_iters + 6, (777,), generator=g, dtype=torch.int32)
    erased = torch.rand((777, 64), generator=g) < 0.1
    s = batch_stats(erased, erased, iters, None, 48, 0, 0, max_iters)
    want = torch.bincount(iters.clamp(0, max_iters).long(), minlength=max_iters + 1)
    assert (iters < 0).any() and (iters > max_iters).any()
    assert s.iters_hist.dtype == torch.int64
    torch.testing.assert_close(s.iters_hist, want, rtol=0, atol=0)
