"""The pattern-only peel's kernel route on the CPU: its stop rule, its
counters, its plain route and the simulation's histogram.

``csrc/peel_mask.cu`` rebuilds the JAX loop's batch-wide stop from two
per-frame quantities (the sweep after which a frame's first k symbols are
known, and the sweep after which its mask stops changing), on 32 frames
bit-sliced into one word per symbol. :func:`kernel_model` is that algorithm
in NumPy, word for word, and :func:`kernel_counts` the simulation's counters
as its counting mode takes them from the same words; both are held here to
the plain route that the CPU takes (and that JAX's test holds,
``test_torch_peel_jacobi.py``) and to ``batch_stats`` over it. The kernel
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
    mask_kernel_fits,
    mask_sweep,
    peel_decode_jacobi_reference,
    peel_decode_mask,
    peel_decode_mask_reference,
    peel_decode_mask_stats,
    rs_windows,
)
from ldpc_erasure_codes_tpu_torch.sim.stats import SimStats, batch_stats

FULL = np.uint32(0xFFFFFFFF)


def _bits(word: np.ndarray) -> np.ndarray:
    """(G,) uint32 -> (G, 32) bool, bit l of group g at [g, l]."""
    return ((word[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words, dtype="<u4").view(np.uint8)).sum())


def kernel_model(arrays, erased: np.ndarray, k_stop: int, max_iters: int):
    """The kernel's algorithm in NumPy: (residual (B, n) bool, iters (B,)
    int32, T). Launch 1 sweeps each group's words until every frame is at
    its fixed point or ``max_iters`` (S_g sweeps), noting d (first sweep with
    the first k_stop known; 0 if none lost; max_iters + 1 if never) and c
    (first t with M(t + 1) = M(t), capped at max_iters); launch 2 sweeps the
    group's first words again min(T, S_g) times, T = min(max_iters, max d,
    max c + 1). Groups are swept together here: a group at its fixed point
    does not change."""
    _, w, iters, t_stop = _model_words(arrays, erased, k_stop, max_iters)
    g, n = w.shape[0], erased.shape[1]
    residual = ((w[:, None, :n] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1).astype(bool)
    return residual.reshape(g * 32, n)[: erased.shape[0]], iters, t_stop


def kernel_counts(arrays, erased: np.ndarray, k_stop: int, max_iters: int, k_count: int,
                  rs_n: int, rs_k: int) -> np.ndarray:
    """The counting mode's counters in NumPy, (9 + max_iters,) int64 in
    ``SimStats``' order, from the kernel's words: launch 1's first words
    give the erasures (a popcount) and each frame's erasures in each RS
    window (a window fails past rs_n - rs_k; none unless rs_n divides n),
    the frames' d give the histogram's bins; launch 2's words at T give the
    residual erasures and, from the OR of the first k_count, the block
    errors."""
    b, n = erased.shape
    first, w, iters, _ = _model_words(arrays, erased, k_stop, max_iters)
    out = np.zeros(9 + max_iters, dtype=np.int64)
    f = {name: i for i, name in enumerate(SimStats._fields)}
    out[f["frames"]] = b
    out[f["erased_symbols"]] = _popcount(first[:, :n])
    out[f["residual_erasures"]] = _popcount(w[:, :n])
    out[f["block_errors"]] = sum(
        _popcount(np.bitwise_or.reduce(w[i, :k_count])) for i in range(w.shape[0])) if k_count else 0
    nwin = rs_windows(n, rs_n)
    if nwin:
        # Bit l of a group's word is frame 32 g + l: its count in window v.
        lanes = (first[:, None, :n] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
        cnt = lanes.reshape(-1, nwin, rs_n).sum(axis=2)[:b]
        out[f["rs_block_errors"]] = int((cnt > rs_n - rs_k).sum())
        out[f["rs_blocks"]] = b * nwin
    hist = np.bincount(np.minimum(iters, max_iters), minlength=max_iters + 1)
    out[f["iters_hist"]:] = hist
    return out


def _model_words(arrays, erased: np.ndarray, k_stop: int, max_iters: int):
    """The model's words: (each group's first words (G, n + 1), its words
    at T (G, n + 1), iters (B,) int32, T)."""
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
    iters = np.where(d == 0, 1, np.minimum(d, max_iters)).astype(np.int32)
    return packed, w, iters, t_stop


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


def _plain_counts(arrays, mask: np.ndarray, max_iters: int, early, k_count: int, rs_n: int,
                  rs_k: int) -> np.ndarray:
    """``batch_stats`` of the plain route, flattened in ``SimStats``' order."""
    erased = torch.from_numpy(mask)
    e, it = peel_decode_mask(arrays, erased, max_iters=max_iters, early_stop_k=early)
    s = batch_stats(erased, e, it, None, k_count, rs_n, rs_k, max_iters,
                    count_all_symbols=k_count == arrays.n)
    return torch.cat([t.reshape(-1) for t in s]).numpy()


@pytest.mark.parametrize("count_all", [False, True])
@pytest.mark.parametrize("b,per,max_iters,early,stop", STOP_CASES)
def test_kernel_counts_equal_batch_stats(arrays_2040, b, per, max_iters, early, stop, count_all):
    """The counting mode's counters, taken from the kernel's words, are
    ``batch_stats`` of the plain route: every stop, budget (0 and 1
    included) and batch of the stop cases, block errors on the first k or
    on every symbol, RS(255,192) windows."""
    k = 1530 if early else 2040
    k_count = 2040 if count_all else 1530
    mask = np.random.default_rng(b * 1000 + max_iters).random((b, 2040)) < per
    got = kernel_counts(arrays_2040, mask, k, max_iters, k_count, 255, 192)
    want = _plain_counts(arrays_2040, mask, max_iters, k if early else None, k_count, 255, 192)
    np.testing.assert_array_equal(got, want)
    assert got[0] == b and got[3] == 8 * b


@pytest.mark.parametrize("n,k,b,per,rs_n,rs_k,max_iters", [
    (50, 33, 40, 0.2, 0, 0, 20),  # no RS comparison
    (50, 33, 40, 0.2, 10, 7, 1),  # windows that divide n
    (101, 60, 70, 0.3, 0, 0, 0),
    (2040, 1530, 33, 0.1875, 250, 125, 50),  # 250 does not divide n: no windows
])
def test_kernel_counts_on_other_codes(n, k, b, per, rs_n, rs_k, max_iters):
    """Toy codes, one whose n is no multiple of 4, and RS windows that do
    not divide n (both RS counters 0, as ``batch_stats`` leaves them)."""
    code = get_code("n2040_k1530") if n == 2040 else toy_code(n=n, k=k, seed=n)
    arrays = code_arrays(code, "cpu")
    mask = np.random.default_rng(n + b).random((b, n)) < per
    for early, k_count in ((k, k), (None, n)):
        got = kernel_counts(arrays, mask, n if early is None else early, max_iters, k_count, rs_n,
                            rs_k)
        want = _plain_counts(arrays, mask, max_iters, early, k_count, rs_n, rs_k)
        np.testing.assert_array_equal(got, want)
        if rs_windows(n, rs_n) == 0:
            assert got[2] == got[3] == 0


def test_mask_kernel_fits_the_shipped_codes_with_their_windows():
    """Every shipped code takes the counting route (its RS windows' counts
    fit launch 1's shared memory); a code whose n is no multiple of 4 does
    not, so the card's step keeps batch_stats there (and the kernel raises)."""
    for name in ("n2040_k1530", "n2000_k1000", "n4000_k2000", "n4080_k3060"):
        code = get_code(name)
        assert mask_kernel_fits(code_arrays(code, "cpu"), code.rs_n), name
    assert not mask_kernel_fits(code_arrays(toy_code(n=101, k=60, seed=101), "cpu"))


@pytest.mark.parametrize("kw,match", [(dict(), "on the card"), (dict(shape=(50,)), "stats"),
                                      (dict(dtype=torch.int32), "stats"),
                                      (dict(k_count=2041), "k_count")])
def test_peel_decode_mask_stats_refusals(arrays_2040, kw, match):
    """The counting launch runs on the card alone (its plain version is
    ``batch_stats`` over :func:`peel_decode_mask`) and takes a buffer of the
    simulation's counters; nothing launches."""
    stats = torch.zeros(kw.get("shape", (9 + 50,)), dtype=kw.get("dtype", torch.int64))
    before = peel_decode_mask.launches
    with pytest.raises(ValueError, match=match):
        peel_decode_mask_stats(arrays_2040, torch.zeros((2, 2040), dtype=torch.bool), stats,
                               max_iters=50, k_count=kw.get("k_count", 1530), rs_n=255, rs_k=192)
    assert peel_decode_mask.launches == before


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
