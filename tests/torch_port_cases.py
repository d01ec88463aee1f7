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
