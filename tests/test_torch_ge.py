"""The port's GF(2) solver against the JAX package's, on the CPU.

Each plain version is held against the Pallas kernel it replaces, run in
interpret mode (the shapes of tests/test_pallas_elim.py,
tests/test_pallas_synd.py and tests/test_pallas_nbmm.py), and the solver's
host functions against their JAX counterparts on the same NumPy inputs.
Everything is integer GF(2) work: equality is exact. Values of frames that
fail are garbage on both sides and are compared only where they did not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import compact as jax_compact
from ldpc_erasure_codes_tpu.ops import ge as jax_ge
from ldpc_erasure_codes_tpu.ops.pallas_elim import f2_eliminate as jax_f2_eliminate
from ldpc_erasure_codes_tpu.ops.pallas_nbmm import (
    f2_apply_scatter as jax_f2_apply_scatter,
    f2_matmul_batched as jax_f2_matmul_batched,
    f2_matvec_wide as jax_f2_matvec_wide,
)
from ldpc_erasure_codes_tpu.ops.pallas_peel import static_topology
from ldpc_erasure_codes_tpu.ops.pallas_synd import syndrome_from_topo as jax_syndrome
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, pack_bits, unpack_bits
from ldpc_erasure_codes_tpu_torch.ops.compact import compact_ge_solve, residual_order
from ldpc_erasure_codes_tpu_torch.ops.elim import f2_eliminate, f2_eliminate_reference
from ldpc_erasure_codes_tpu_torch.ops.ge import erased_indices, ge_solve_packed
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_scatter,
    f2_matmul_batched,
    f2_matvec_wide,
)
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words


def _byte_words(x: np.ndarray) -> np.ndarray:
    """(…, 4W) uint8 byte view -> (…, W) uint32 words with the same bits."""
    return np.ascontiguousarray(x).view(np.uint32)


def _random_cube(rng, c, m, b):
    r = rng.integers(0, 1 << 32, (c, m, b), dtype=np.uint32)
    r &= rng.integers(0, 1 << 32, (c, m, b), dtype=np.uint32)
    return r


def _zero_pad_columns(r, nreal, emax):
    """Zero A bits >= nreal per frame (the solver's pad-column invariant)."""
    for f in range(r.shape[2]):
        for col in range(int(nreal[f]), emax):
            r[col >> 5, :, f] &= ~np.uint32(1 << (col & 31))


def _elim_case(cut: bool):
    rng = np.random.default_rng(4 if cut else 0)
    if cut:  # tests/test_pallas_elim.py::test_f2_a_words_cuts_are_exact
        c, m, b, emax = 6, 24, 256, 64
        r = _random_cube(rng, c, m, b)
        r[:, 20:, :] = 0
        nreal = rng.integers(0, emax + 1, b).astype(np.int32)
        nreal[:4] = [0, 3, 40, 64]
        _zero_pad_columns(r, nreal, emax)
        return r, nreal, emax, emax // 32
    # tests/test_pallas_elim.py::test_matches_reference_elimination
    c, m, b, emax = 4, 24, 256, 40
    r = _random_cube(rng, c, m, b)
    r[:, :, :3] = 0  # all-zero frames fail
    r[:, 20:, :] = 0  # pad-style zero rows
    nreal = rng.integers(0, emax + 1, b).astype(np.int32)
    return r, nreal, emax, 0


@pytest.mark.parametrize("cut", [False, True], ids=["a_words_0", "a_words_wa"])
def test_f2_eliminate_matches_pallas(cut):
    r, nreal, emax, a_words = _elim_case(cut)
    j_r, j_piv, j_fail = (
        np.asarray(x)
        for x in jax_f2_eliminate(
            jnp.asarray(r), jnp.asarray(nreal[None]), emax=emax, b_tile=128,
            interpret=True, a_words=a_words,
        )
    )
    cube = to_torch(np.transpose(r, (2, 1, 0)))  # (B, m, C)
    before = f2_eliminate.launches
    p_r, p_piv, p_fail = f2_eliminate(cube, torch.from_numpy(nreal), emax=emax, a_words=a_words)
    assert f2_eliminate.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(p_piv.numpy(), j_piv.T)
    np.testing.assert_array_equal(p_fail.numpy(), j_fail[0] != 0)
    np.testing.assert_array_equal(to_words(p_r), np.transpose(j_r, (2, 1, 0)))
    assert p_fail.any() and not p_fail.all()
    if cut:  # the cuts change no pivot, no flag, no solved frame's cube
        base_r, base_piv, base_fail = f2_eliminate_reference(
            cube, torch.from_numpy(nreal), emax=emax
        )
        assert torch.equal(base_piv, p_piv) and torch.equal(base_fail, p_fail)
        assert torch.equal(base_r[~p_fail], p_r[~p_fail])


def test_syndrome_matches_pallas():
    jcode = small_jax_code()
    jarr = device_arrays(jcode)
    rng = np.random.default_rng(3)
    b, w = 8, 4
    values = random_words(rng, (b, jcode.n, w))
    values[rng.random((b, jcode.n)) < 0.2] = 0  # erased slots hold zero
    m_pad = -(-jcode.m // 8) * 8
    want = np.asarray(jax_syndrome(
        jnp.asarray(values), topo=static_topology(jarr), m_pad=m_pad, bt=4, interpret=True
    ))
    arrays = code_arrays(to_port_code(jcode), "cpu")
    before = syndrome_from_topo.launches
    got = syndrome_from_topo(arrays, to_torch(values))
    assert syndrome_from_topo.launches == before
    np.testing.assert_array_equal(to_words(got), _byte_words(want)[:, : jcode.m])
    dense = f2_matvec_wide(to_torch(values), arrays.h_words)
    assert torch.equal(dense, got)


def test_f2_products_match_pallas():
    """tests/test_pallas_nbmm.py::test_f2_matvec_and_apply_scatter's shapes:
    the matrices go to the port packed, the byte rows as words."""
    rng = np.random.default_rng(5)
    b, n_pad, m_pad, e_pad, wb = 2, 64, 16, 16, 256
    n_real, e_real = 60, 12
    h = (rng.random((m_pad, n_pad)) < 0.2).astype(np.int8)
    h[14:, :] = 0
    h[:, n_real:] = 0
    y = rng.integers(0, 256, (b, n_pad, wb), dtype=np.uint8)
    y[:, n_real:, :] = 0
    rhs = jax_f2_matvec_wide(jnp.asarray(y), jnp.asarray(h), interpret=True)
    h_words = pack_bits(torch.from_numpy(h))
    got_rhs = f2_matvec_wide(to_torch(_byte_words(y)), h_words)
    np.testing.assert_array_equal(to_words(got_rhs), _byte_words(np.asarray(rhs)))

    t = (rng.random((b, e_pad, m_pad)) < 0.3).astype(np.int8)
    t[:, e_real:, :] = 0
    t_words = pack_bits(torch.from_numpy(t))
    x = jax_f2_matmul_batched(rhs, jnp.asarray(t), interpret=True)
    got_x = f2_matmul_batched(got_rhs, t_words)
    np.testing.assert_array_equal(to_words(got_x), _byte_words(np.asarray(x)))

    idx = np.stack([
        np.concatenate([rng.choice(n_real, e_real, replace=False), np.full(e_pad - e_real, n_real)])
        for _ in range(b)
    ]).astype(np.int32)
    vals = y.copy()
    for f in range(b):
        vals[f, idx[f, :e_real]] = 0
    out = np.asarray(jax_f2_apply_scatter(
        jnp.asarray(vals), rhs, jnp.asarray(t), jnp.asarray(idx), interpret=True
    ))
    # The port's frames are the n_real real symbols; target n_real is a discard.
    got = f2_apply_scatter(
        to_torch(_byte_words(vals[:, :n_real])), got_rhs, t_words, torch.from_numpy(idx)
    )
    np.testing.assert_array_equal(to_words(got), _byte_words(out[:, :n_real]))


def test_bits_round_trip_and_ignore_bits_past_k():
    rng = np.random.default_rng(9)
    bits = torch.from_numpy((rng.random((3, 5, 96)) < 0.5).astype(np.uint8))
    words = pack_bits(bits)
    assert words.shape == (3, 5, 3) and words.dtype == torch.int32
    assert torch.equal(unpack_bits(words), bits)
    want = np.packbits(bits.numpy(), axis=-1, bitorder="little").view(np.uint32)
    np.testing.assert_array_equal(to_words(words), want)
    # Bits of a matrix row at or past K (here 40 of 64) take no part.
    rhs = to_torch(random_words(rng, (3, 40, 2)))
    t = to_torch(random_words(rng, (3, 4, 2)))
    t_clean = t & to_torch(np.array([0xFFFFFFFF, 0xFF], dtype=np.uint32))
    assert torch.equal(f2_matmul_batched(rhs, t), f2_matmul_batched(rhs, t_clean))


@pytest.mark.parametrize("emax", [5, 30, 100])
def test_erased_indices_matches_jax(emax):
    rng = np.random.default_rng(emax)
    erased = rng.random((6, 48)) < 0.3
    erased[0] = False
    erased[1] = True
    want = jax_ge.erased_indices(jnp.asarray(erased), min(emax, 48))
    got = erased_indices(torch.from_numpy(erased), emax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[2].dtype == torch.int32


def _small_ge_case(seed, b=24, w=3, per=0.35):
    """Peeled frames of the small code: (jcode, arrays, values, erased,
    codewords), erased slots zero."""
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
    from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode

    jcode = small_jax_code()
    arrays = code_arrays(to_port_code(jcode), "cpu")
    rng = np.random.default_rng(seed)
    cw = encode_packed(arrays, to_torch(random_words(rng, (b, jcode.k, w))))
    mask = torch.from_numpy(rng.random((b, jcode.n)) < per)
    v, e, _ = peel_decode(arrays, cw, mask, max_iters=2)
    return jcode, arrays, v, e, cw


@pytest.mark.parametrize("emax", [12, 64])
@pytest.mark.parametrize("return_rows", [False, True])
@pytest.mark.parametrize("static_topo", [False, True])
def test_ge_solve_packed_matches_jax(emax, return_rows, static_topo):
    jcode, arrays, v, e, cw = _small_ge_case(21)
    jarr = device_arrays(jcode)
    want = jax_ge.ge_solve_packed(
        jarr, jnp.asarray(to_words(v)), jnp.asarray(e.numpy()), emax=emax,
        return_rows=return_rows,
    )
    got = ge_solve_packed(arrays, v, e, emax=emax, return_rows=return_rows,
                          static_topo=static_topo)
    failed = got[-1].numpy()
    np.testing.assert_array_equal(failed, np.asarray(want[-1]))
    np.testing.assert_array_equal(got[-2].numpy(), np.asarray(want[-2]))
    ok = ~failed
    assert ok.any() and failed.any()  # solved and failed frames both occur
    if return_rows:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(to_words(got[0])[ok], np.asarray(want[0])[ok])
        return
    pv = to_words(got[0])
    np.testing.assert_array_equal(pv[ok], np.asarray(want[0])[ok])
    np.testing.assert_array_equal(pv[ok], to_words(cw)[ok])  # solved frames are codewords


def test_residual_order_matches_jax():
    erased = np.zeros((7, 5), bool)
    erased[[1, 4, 5], [0, 2, 3]] = True
    for f_max in (1, 2, 3, 7, 9):
        want = jax_compact.residual_order(jnp.asarray(erased), f_max)
        got = residual_order(torch.from_numpy(erased), f_max)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("f_max", [4, 24])
def test_compact_ge_solve_matches_jax(f_max):
    jcode, arrays, v, e, _ = _small_ge_case(22)
    jv, je, jf = (
        np.asarray(x)
        for x in jax_compact.compact_ge_solve(
            device_arrays(jcode), jnp.asarray(to_words(v)), jnp.asarray(e.numpy()),
            emax=40, f_max=f_max,
        )
    )
    v_in = v.clone()
    pv, pe, pf = compact_ge_solve(arrays, v, e, emax=40, f_max=f_max)
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pe.numpy(), je)
    ok = ~jf
    np.testing.assert_array_equal(to_words(pv)[ok], jv[ok])
    assert torch.equal(v, v_in)  # the input is not modified
    assert int(e.any(dim=1).sum()) > 4  # f_max=4 spills residual frames


def test_wrappers_validate_their_inputs():
    cube = torch.zeros((2, 8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        f2_eliminate(cube, torch.zeros(3, dtype=torch.int32), emax=8)
    with pytest.raises(ValueError):
        f2_eliminate(cube, torch.zeros(2, dtype=torch.int32), emax=97)
    with pytest.raises(TypeError):
        f2_eliminate(cube.long(), torch.zeros(2, dtype=torch.int32), emax=8)
    rhs = torch.zeros((2, 40, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        f2_matmul_batched(rhs, torch.zeros((2, 5, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        f2_apply_scatter(torch.zeros((2, 50, 4), dtype=torch.int32), rhs,
                         torch.zeros((2, 5, 2), dtype=torch.int32),
                         torch.zeros((2, 4), dtype=torch.int32))
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    with pytest.raises(ValueError):
        ge_solve_packed(arrays, torch.zeros((2, 40, 4), dtype=torch.int32),
                        torch.zeros((2, 40), dtype=torch.bool), emax=8)
    with pytest.raises(ValueError):
        syndrome_from_topo(arrays, torch.zeros((2, 47, 4), dtype=torch.int32))
