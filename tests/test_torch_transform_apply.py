"""The port's transform rows and GF(256) transform apply against the JAX
package's, on the CPU.

``f2_matmul_rows_reference`` (the plain version in the order of
``f2_matmul_batched``'s list route, ``csrc/f2mm.cu``) and
``gf_apply_tiles_reference`` (the plain version in the order of
``gf_apply_scatter``'s tiled kernel, ``csrc/gfmm.cu``) are held against the
Pallas kernels they replace, run in interpret mode, on the GE operands of
peeled or erased frames that the port's plain solver pipeline makes, and
against the port's other plain versions on random shapes. GF(2) and
GF(256) integer work: every comparison is exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops.pallas_nbmm import (
    f2_matmul_batched as jax_f2_matmul_batched,
    gf_apply_scatter as jax_gf_apply_scatter,
)
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import nbmm
from ldpc_erasure_codes_tpu_torch.ops._build import SMEM_LIMIT
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, pack_bits, unpack_bits
from ldpc_erasure_codes_tpu_torch.ops.elim import f2_eliminate_reference, gf256_eliminate_reference
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import (
    _unpack_words_bytes,
    coefficient_cube,
    coefficient_cube_nb,
    erased_indices,
    pivot_transforms,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.rs import rs_code, rs_encode
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words


@functools.cache
def _binary_operands(name: str):
    """(rhs (B, K, W) int32, T rows (B, E, KW) int32) of ``ge_solve_packed``
    for peeled frames of a binary code, by the port's plain pipeline: the
    small code at emax 13 (E not a multiple of 8) and 3 frames of the
    (2040,1530) GE bucket's shape (PER .2031, 10 sweeps, emax 512)."""
    if name == "small":
        code, b, w, per, sweeps, emax = to_port_code(small_jax_code()), 6, 3, 0.35, 2, 13
    else:
        code, b, w, per, sweeps, emax = get_code(name), 3, 2, 0.2031, 10, 512
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(len(name))
    cw = encode_packed(arrays, to_torch(random_words(rng, (b, code.k, w))))
    mask = torch.from_numpy(rng.random((b, code.n)) < per)
    values, erased, _ = peel_decode(arrays, cw, mask, max_iters=sweeps)
    assert bool(erased.any())
    emax = min(emax, code.n)
    er_idx, real, nreal = erased_indices(erased, emax)
    wa = -(-emax // 32)
    r, pivrow, _ = f2_eliminate_reference(coefficient_cube(arrays, er_idx, real), nreal,
                                          emax=emax, a_words=wa)
    return nbmm.f2_matvec_wide(values, arrays.h_words), pivot_transforms(r, pivrow, wa)


@pytest.mark.parametrize("name", ["small", "n2040_k1530"])
def test_f2_matmul_rows_reference_matches_pallas(name):
    """The rows of T . rhs in order, against JAX's f2_matmul_batched on
    the same bits: JAX takes the 0/1 matrix over K columns with its rows
    padded to a multiple of 8; the port's packed rows carry set bits past
    K (ignored) and two rows zeroed (a row with an empty list)."""
    rhs, t_rows = _binary_operands(name)
    b, k, w = rhs.shape
    e = t_rows.shape[1]
    rng = np.random.default_rng(k)
    t_rows = t_rows.clone()
    t_rows[:, [0, e // 2]] = 0
    bits = unpack_bits(t_rows)[..., :k]
    assert bool(bits.any()) and not bool(bits[:, 0].any())
    e_pad = -(-e // 8) * 8
    t01 = np.zeros((b, e_pad, k), np.int8)
    t01[:, :e] = bits.numpy()
    want = np.asarray(jax_f2_matmul_batched(
        jnp.asarray(to_words(rhs).view(np.uint8)), jnp.asarray(t01), interpret=True))
    kw = t_rows.shape[2]
    past = np.zeros((b, e, 32 * kw), bool)
    past[..., k:] = rng.random((b, e, 32 * kw - k)) < 0.5
    dirty = t_rows | pack_bits(torch.from_numpy(past))
    if 32 * kw > k:
        assert not torch.equal(dirty, t_rows)
    got = nbmm.f2_matmul_rows_reference(rhs, dirty)
    np.testing.assert_array_equal(to_words(got), want.view(np.uint32)[:, :e])
    assert not bool(got[:, 0].any())
    assert torch.equal(got, nbmm.f2_matmul_batched(rhs, dirty))  # the wrapper's CPU path


@functools.cache
def _gf_operands(name: str):
    """(values, rhs, T rows, idx) of ``ge_solve_wide_nb`` by the port's plain
    pipeline: RS(255,192), B=3, 8-byte payloads, 40 to 60 erasures a frame
    (E = 63: two tiles of 32), and the small code lifted to GF(256) at emax
    20 and 14 (one tile of 32, one of 16)."""
    if name == "rs":
        code, b, wb, emax = rs_code(255, 192), 3, 8, 63
    else:
        code, b, wb, emax = to_port_code(small_jax_code().lift_to_gf256(seed=0)), 4, 8, int(name)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(emax)
    src = torch.from_numpy(rng.integers(0, 256, (b, code.k, wb), dtype=np.uint8))
    if name == "rs":
        cw = rs_encode(arrays, src)
        mask = np.zeros((b, code.n), bool)
        for f in range(b):
            mask[f, rng.choice(code.n, 40 + 10 * f, replace=False)] = True
        mask = torch.from_numpy(mask)
    else:
        cw = encode_packed(arrays, src, gf_order=256)
        mask = torch.from_numpy(rng.random((b, code.n)) < 0.25)
    values = cw.masked_fill(mask[:, :, None], 0)
    er_idx, real, nreal = erased_indices(mask, emax)
    wa = -(-emax // 4)
    r, pivrow, _ = gf256_eliminate_reference(coefficient_cube_nb(arrays, er_idx, real), nreal,
                                             emax=emax, a_words=wa)
    t_top = _unpack_words_bytes(pivot_transforms(r, pivrow, wa))[:, :, :arrays.m].contiguous()
    rhs = nbmm.gf_matvec_wide(values, arrays.vlist_idx, arrays.vlist_val)
    idx = torch.where(real & (nreal <= emax)[:, None], er_idx, code.n).to(torch.int32)
    return values, rhs, t_top, idx


@pytest.mark.parametrize("name", ["rs", "20", "14"])
def test_gf_apply_tiles_reference_matches_pallas(name):
    """The solved rows placed in the erased slots, against JAX's
    gf_apply_scatter: targets past the real ones (pad slots and frames that
    overflow) and a frame with every target out of range are dropped; JAX
    takes them at its dump row n, with its rows padded to a multiple of 8;
    E is not a multiple of the tile size R."""
    values, rhs, mats, idx = _gf_operands(name)
    b, n, wb = values.shape
    e, m = mats.shape[1:]
    idx = idx.clone()
    idx[1] = torch.where(torch.arange(e) % 2 == 0, n, -1)  # a frame that places no row
    keep = (idx >= 0) & (idx < n)
    assert bool(keep.any()) and bool((~keep).any())  # placed and dropped rows
    assert e % nbmm.gf_apply_rows(e) != 0
    e_pad, m_pad = -(-e // 8) * 8, -(-m // 8) * 8  # the TPU kernel's bit image needs both
    jv = np.zeros((b, n + 1, wb), np.uint8)
    jv[:, :n] = values.numpy()
    jr = np.zeros((b, m_pad, wb), np.uint8)
    jr[:, :m] = rhs.numpy()
    jm = np.zeros((b, e_pad, m_pad), np.uint8)
    jm[:, :e, :m] = mats.numpy()
    ji = np.full((b, e_pad), n, np.int32)
    ji[:, :e] = np.where(keep.numpy(), idx.numpy(), n)
    want = np.asarray(jax_gf_apply_scatter(jnp.asarray(jv), jnp.asarray(jr), jnp.asarray(jm),
                                           jnp.asarray(ji), interpret=True))
    got = nbmm.gf_apply_tiles_reference(values, rhs, mats, idx)
    np.testing.assert_array_equal(got.numpy(), want[:, :n])
    assert torch.equal(got[1], values[1])
    assert torch.equal(got, nbmm.gf_apply_scatter(values, rhs, mats, idx))  # the CPU path


@pytest.mark.parametrize("b,k,e,w", [(1, 1, 1, 1), (3, 40, 9, 5), (2, 70, 33, 3), (2, 510, 64, 2),
                                     (2, 33, 0, 4), (4, 96, 17, 1)])
def test_f2_matmul_rows_reference_matches_plain(b, k, e, w):
    """On random rhs and T rows of ~20% set bits, some rows empty and bits
    past K set: the list order's product equals the bit-plane product."""
    rng = np.random.default_rng(k + e + w)
    kw = -(-k // 32)
    rhs = to_torch(random_words(rng, (b, k, w)))
    bits = rng.random((b, e, 32 * kw)) < 0.2
    bits[:, ::3, :k] = False
    t = pack_bits(torch.from_numpy(bits))
    got = nbmm.f2_matmul_rows_reference(rhs, t)
    assert got.shape == (b, e, w)
    assert torch.equal(got, nbmm.f2_matmul_batched_reference(rhs, t))


@pytest.mark.parametrize("b,n,m,e,wb", [(1, 5, 1, 1, 4), (3, 40, 9, 5, 12), (2, 255, 63, 63, 8),
                                        (2, 100, 30, 70, 4), (2, 60, 16, 16, 8),
                                        (3, 300, 20, 100, 4)])
def test_gf_apply_tiles_reference_matches_plain(b, n, m, e, wb):
    """On random frames (values in every slot, targets among them), random
    byte matrices, targets dropped at -1, n and beyond, and a frame placing
    no row: the tile order's apply equals the column loop's."""
    rng = np.random.default_rng(n + e)
    values = torch.from_numpy(rng.integers(0, 256, (b, n, wb), dtype=np.uint8))
    rhs = torch.from_numpy(rng.integers(0, 256, (b, m, wb), dtype=np.uint8))
    mats = torch.from_numpy(rng.integers(0, 256, (b, e, m), dtype=np.uint8))
    idx = np.stack([rng.permutation(n + e)[:e] for _ in range(b)]).astype(np.int32)
    idx[idx >= n] = rng.choice([-1, n, n + 7], int((idx >= n).sum()))
    idx[-1] = n  # a frame that places no row
    idx = torch.from_numpy(idx)
    got = nbmm.gf_apply_tiles_reference(values, rhs, mats, idx)
    assert torch.equal(got, nbmm.gf_apply_scatter_reference(values, rhs, mats, idx))
    assert torch.equal(got[-1], values[-1])


def test_routes_from_shapes():
    """The shape arithmetic the wrappers choose their kernels by: the GE
    bucket's rows take the list route at Wc 32, larger K the bit scan, and
    K past the bit scan's staging no route; the apply's tiles hold 16 rows
    up to E = 16 and 32 beyond, and its blocks at the RS and NB shapes fit
    shared memory."""
    assert nbmm.f2_matmul_route(510, 256) == "list"
    assert nbmm.f2_matmul_slab_words(510, 256) == nbmm.F2_MATMUL_WORDS[0] == 32
    assert nbmm.f2_matmul_slab_words(510, 5) == 8  # no wider than W rounded up to 4
    assert nbmm.f2_matmul_route(6000, 256) == "scan"
    assert nbmm.f2_matmul_route(40000, 1) is None
    assert nbmm.f2_matmul_smem(510, 32) <= SMEM_LIMIT < nbmm.f2_matmul_smem(6000, 4)
    assert [nbmm.gf_apply_rows(e) for e in (1, 16, 17, 63, 512)] == [16, 16, 32, 32, 32]
    assert nbmm.gf_apply_smem(63, 255, 32) <= SMEM_LIMIT
    assert nbmm.gf_apply_smem(2040, 2040, 32) <= SMEM_LIMIT < nbmm.gf_apply_smem(60000, 255, 32)
