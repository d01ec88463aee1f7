"""Shared inputs for the PyTorch port's tests (``test_torch_*.py``).

Inputs are made with NumPy from fixed seeds and handed to both sides: the
JAX package (the reference) and the port. Words travel as uint32 on the JAX
side and as the same bits viewed as int32 on the port's side.
"""

import functools

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import from_vlist


@functools.cache
def small_jax_code():
    """The small generated code of tests/test_pallas_peel.py (n=48, k=32),
    built on the JAX side."""
    from ldpc_erasure_codes_tpu.codes import gen_row_wise

    return gen_row_wise([(16, 6)], [(48, 2)], seed=3, max_tries=40, strict_tries=4)


def to_port_code(jcode):
    """The port's LDPCCode for a JAX LDPCCode, handed over as NumPy."""
    return from_vlist(
        jcode.name, jcode.n, jcode.k, jcode.vlist_idx, jcode.vlist_len,
        jcode.vlist_val, jcode.gf_order,
    )


def random_words(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def to_torch(words: np.ndarray) -> torch.Tensor:
    """uint32 NumPy words -> int32 torch tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def to_words(t: torch.Tensor) -> np.ndarray:
    """int32 torch tensor -> uint32 NumPy words with the same bits."""
    return t.cpu().numpy().view(np.uint32)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none. Decided at run
    time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def check_levels(arrays, erased, res, lvl_off, nlev) -> None:
    """Each resolution solves a symbol erased on input, no symbol twice,
    from neighbours of lower levels (known inputs are level 0); the list is
    sorted by level and ``lvl_off``/``nlev`` describe it."""
    vidx, vlen = arrays.vlist_idx.numpy(), arrays.vlist_len.numpy()
    n = erased.shape[1]
    for f in range(erased.shape[0]):
        off = lvl_off[f]
        nres = off[-1]
        assert (np.diff(off) >= 0).all() and off[0] == 0
        assert (off[nlev[f]:] == nres).all() and (nlev[f] == 0 or off[nlev[f] - 1] < nres)
        assert (res[f, nres:] == -1).all()
        level = np.where(erased[f], n + 1, 0)  # unresolved: never readable
        entries = []
        for lv in range(1, nlev[f] + 1):
            for r in range(off[lv - 1], off[lv]):
                c, es = res[f, r] >> 8, res[f, r] & 255
                e = vidx[c, es]
                assert erased[f, e] and level[e] == n + 1, (f, r)
                entries.append((lv, c, es, e))
                level[e] = lv
        for lv, c, es, e in entries:
            others = [vidx[c, j] for j in range(vlen[c]) if j != es]
            assert all(level[s] < lv for s in others), (f, c, lv)


def rank_edge_masks(arrays, k: int, emax: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Erasure masks at the rank check's edges, on the CPU: (B, n) bool and
    the frames whose last erased column is dependent by construction.

    Frames: no erasure; 31, 32 and 33 erasures (a word of columns, one
    short, one over) and emax and emax + 1 (the bucket full, one over) on
    random symbols; then, for T = 65, 96 and emax columns (the first column
    of a word, the last of one, the last the bucket holds), the support of
    a codeword with one source bit set (its columns sum to zero) filled up
    to T symbols with random ones below its last symbol, so that the last
    column, T - 1, is dependent; and the same set without that symbol.
    ``k`` is the code's dimension; ``arrays`` its CPU tables."""
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode

    n = arrays.n
    rng = np.random.default_rng(seed)
    rows, dependent = [np.zeros(n, dtype=bool)], []
    for count in (31, 32, 33, emax, emax + 1):
        row = np.zeros(n, dtype=bool)
        row[rng.choice(n, min(count, n), replace=False)] = True
        rows.append(row)
    cw = encode(arrays, torch.eye(k, dtype=torch.uint8)).bool().numpy()
    weight, last = cw.sum(axis=1), n - 1 - cw[:, ::-1].argmax(axis=1)
    for t in sorted({65, 96, emax}):
        fits = np.nonzero((weight <= t) & (last >= t - 1))[0]
        if t > min(emax, n) or fits.size == 0:
            continue
        pick = fits[np.argmin(weight[fits])]
        support = cw[pick].copy()
        below = np.nonzero(~support[: last[pick]])[0]
        support[rng.choice(below, t - int(support.sum()), replace=False)] = True
        dependent.append(len(rows))
        rows.append(support)
        kept = support.copy()
        kept[last[pick]] = False
        rows.append(kept)
    mask = torch.from_numpy(np.stack(rows))
    return mask, torch.tensor(dependent, dtype=torch.long)


def window_cascade(arrays, width: int = 16) -> tuple[int, int, int, int]:
    """(e, f, c1, c2): checks c1 < c2 within one window of ``width``
    consecutive checks (width 16 is the counted schedule kernel's at dmax
    <= 16, and lies within the plain version's 32) that share symbol e, c1
    being e's first check, and f a neighbour of c2, not of c1, whose first
    check is c2. With e and f erased alone, c1 solves e and lowers c2's
    count from 2 to 1, so c2 solves f later in the same sweep."""
    nbs = [row[:d] for row, d in zip(arrays.vlist_idx.tolist(), arrays.vlist_len.tolist())]
    checks = [row[:d] for row, d in zip(arrays.clist_idx.tolist(), arrays.clist_len.tolist())]
    for e, ce in enumerate(checks):
        c1 = min(ce)
        for c2 in ce:
            if c2 > c1 and c2 // width == c1 // width:
                for f in nbs[c2]:
                    if f != e and f not in nbs[c1] and min(checks[f]) == c2:
                        return e, f, c1, c2
    raise ValueError("no two checks of one window cascade")


def cube_edge_masks(n: int, emax: int, seed: int) -> torch.Tensor:
    """Erasure masks at the GE cube's edges, on the CPU, (B, n) bool: none
    erased; all erased; 31, 32 and 33 erasures (a word of columns, one
    short, one over); emax - 1, emax and emax + 1 (the bucket one short,
    full, one over; counts past n dropped); and one frame at random at
    20%. ``emax`` is clamped to n."""
    rng = np.random.default_rng(seed)
    emax = min(emax, n)
    rows = [np.zeros(n, dtype=bool), np.ones(n, dtype=bool)]
    for count in sorted({31, 32, 33, emax - 1, emax, emax + 1}):
        if 0 <= count <= n:
            row = np.zeros(n, dtype=bool)
            row[rng.choice(n, count, replace=False)] = True
            rows.append(row)
    rows.append(rng.random(n) < 0.2)
    return torch.from_numpy(np.stack(rows))
