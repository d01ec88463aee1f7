"""The orders of the port's elimination and apply kernels (``csrc/elim.cu``
32 columns at a time, ``csrc/f2mm.cu`` placed rows only over their column
lists) as plain PyTorch, against the column-order plain versions and the
JAX package's Pallas kernels in interpret mode, on the CPU.

Everything is integer GF(2) work: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops.pallas_elim import f2_eliminate as jax_f2_eliminate
from ldpc_erasure_codes_tpu.ops.pallas_nbmm import f2_apply_scatter as jax_f2_apply_scatter
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, pack_bits
from ldpc_erasure_codes_tpu_torch.ops.elim import (
    f2_eliminate_panels_reference,
    f2_eliminate_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import coefficient_cube, erased_indices
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_rows_reference,
    f2_apply_scatter_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from torch_port_cases import random_words, to_torch, to_words

B_TILE = 128  # the JAX kernel's frames per program


def _jax_eliminate(cube: torch.Tensor, nreal: torch.Tensor, emax: int, a_words: int):
    """JAX's interpret-mode kernel on the port's (B, m, C) cube, its frames
    padded to the lane tile and its rows to a multiple of 8 (zero frames
    and zero rows, which never pivot); returned in the port's layout."""
    b, m, c = cube.shape
    bp, mp = -(-b // B_TILE) * B_TILE, -(-m // 8) * 8
    r = np.zeros((c, mp, bp), dtype=np.uint32)
    r[:, :m, :b] = to_words(cube).transpose(2, 1, 0)
    nr = np.zeros((1, bp), dtype=np.int32)
    nr[0, :b] = nreal.numpy()
    out, piv, fail = jax_f2_eliminate(jnp.asarray(r), jnp.asarray(nr), emax=emax, b_tile=B_TILE,
                                      interpret=True, a_words=a_words)
    return (np.asarray(out)[:, :m, :b].transpose(2, 1, 0), np.asarray(piv)[:, :b].T,
            np.asarray(fail)[0, :b] != 0)


def _assert_all_equal(cube, nreal, emax, a_words):
    """Panel order == column order == JAX, on every output; returns the
    panel order's work counts."""
    stats = {}
    got = f2_eliminate_panels_reference(cube, nreal, emax=emax, a_words=a_words, stats=stats)
    want = f2_eliminate_reference(cube, nreal, emax=emax, a_words=a_words)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    j_r, j_piv, j_fail = _jax_eliminate(cube, nreal, emax, a_words)
    np.testing.assert_array_equal(to_words(got[0]), j_r)
    np.testing.assert_array_equal(got[1].numpy(), j_piv)
    np.testing.assert_array_equal(got[2].numpy(), j_fail)
    return got, stats


def _random_cube(rng, b, m, c, emax, zero_pad_columns):
    """Sparse random systems: a third of the frames have no rows below
    m - 4, the last two are all zero (they fail), frame 0's word 0 and
    frame 1's word 1 are zero in every row (panels the kernel skips); with
    ``zero_pad_columns`` the A bits at or past each frame's nreal are zero,
    as the solver leaves them."""
    r = random_words(rng, (b, m, c)) & random_words(rng, (b, m, c))
    r[: b // 3, m - 4:] = 0
    r[-2:] = 0
    r[0, :, 0] = 0
    r[1, :, 1] = 0
    nreal = rng.integers(0, emax + 1, b).astype(np.int32)
    if zero_pad_columns:
        cols = np.arange(32 * c)
        keep = (cols[None, :] < nreal[:, None]) | (cols[None, :] >= emax)
        r &= np.packbits(keep, axis=1, bitorder="little").view(np.uint32)[:, None, :]
    return to_torch(r), torch.from_numpy(nreal)


@pytest.mark.parametrize("cut", [False, True], ids=["a_words_0", "a_words_wa"])
@pytest.mark.parametrize("b,m,c,emax", [(12, 44, 4, 40), (9, 70, 6, 100), (6, 24, 3, 64)])
def test_panel_order_matches_column_order_and_pallas(cut, b, m, c, emax):
    """m not a multiple of 32, ub a partial panel (40, 100) or whole ones
    (64), all-zero frames and frames with a zero panel."""
    cube, nreal = _random_cube(np.random.default_rng(m + emax), b, m, c, emax, cut)
    (_, _, failed), stats = _assert_all_equal(cube, nreal, emax, -(-emax // 32) if cut else 0)
    assert failed[-2:].all() and not failed.all()
    assert 0 < stats["live_panels"] < stats["panels"]  # the skip ran, and so did panels
    assert stats["column_steps"] <= 32 * stats["live_panels"]


@pytest.mark.parametrize("cut", [False, True], ids=["a_words_0", "a_words_wa"])
def test_panel_order_on_peeled_toy_frames(cut):
    """The cube ``ge_solve_packed`` builds for peeled frames of a toy code
    with m = 40 rows, emax 48 (a partial second panel)."""
    code = toy_code(n=100, k=60, seed=3)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(8)
    b, emax = 16, 48
    cw = encode_packed(arrays, to_torch(random_words(rng, (b, code.k, 2))))
    mask = torch.from_numpy(rng.random((b, code.n)) < 0.3)
    mask[0] = False  # nothing left for the GE
    _, erased, _ = peel_decode(arrays, cw, mask, max_iters=2)
    er_idx, real, nreal = erased_indices(erased, emax)
    cube = coefficient_cube(arrays, er_idx, real)
    assert cube.shape[1] == 40 and bool(erased.any())
    (_, _, failed), _ = _assert_all_equal(cube, nreal, emax, -(-emax // 32) if cut else 0)
    assert not failed.all()


def test_apply_rows_match_pallas():
    """The list order of the apply equals the scatter reference and JAX's
    interpret-mode apply: targets at -1, n and n + 100 are dropped, frame 2
    places no row, and bits of T past K are ignored."""
    rng = np.random.default_rng(12)
    b, n, n_pad, k, e, wb = 3, 60, 64, 16, 16, 8
    values = rng.integers(0, 256, (b, n_pad, wb), dtype=np.uint8)
    rhs = rng.integers(0, 256, (b, k, wb), dtype=np.uint8)
    t = (rng.random((b, e, k)) < 0.3).astype(np.int8)
    idx = np.stack([rng.permutation(n)[:e] for _ in range(b)]).astype(np.int32)
    idx[0, :3] = [-1, n, n + 100]
    idx[1, 5:9] = n + 100
    idx[2] = rng.choice([-1, n, n + 100], e)
    want = np.asarray(jax_f2_apply_scatter(jnp.asarray(values), jnp.asarray(rhs),
                                           jnp.asarray(t), jnp.asarray(idx), interpret=True))

    def words(x):
        return to_torch(np.ascontiguousarray(x).view(np.uint32))

    t_words = pack_bits(torch.from_numpy(np.concatenate(
        [t, np.ones((b, e, 32 - k), dtype=np.int8)], axis=2)))  # bits past K set
    args = (words(values[:, :n]), words(rhs), t_words, torch.from_numpy(idx))
    got = f2_apply_rows_reference(*args)
    assert torch.equal(got, f2_apply_scatter_reference(*args))
    np.testing.assert_array_equal(to_words(got), want[:, :n].view(np.uint32))
    assert torch.equal(got[2], args[0][2])  # nothing placed
