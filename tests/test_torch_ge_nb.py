"""The port's GF(256) Gauss-Jordan against the JAX package's, on the CPU.

The plain versions of the three GE kernels (``gf256_eliminate``,
``gf_matvec_wide``, ``gf_apply_scatter``) are held against the Pallas
kernels they replace, run in interpret mode at the shapes of
tests/test_pallas_elim.py and tests/test_pallas_nbmm.py; ``ge_solve``,
``ge_solve_wide_nb``, ``compact_ge_solve`` and the hybrid decoder with
``gf_order=256`` against their JAX counterparts on the same NumPy inputs.
Finite-field integer work: equality is exact. Values of failed frames are
garbage on both sides (and with the ``a_words`` cuts, so are their cubes),
so they are compared only where the frame did not fail.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import compact as jax_compact
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import ge as jax_ge
from ldpc_erasure_codes_tpu.ops import hybrid as jax_hybrid
from ldpc_erasure_codes_tpu.ops.pallas_elim import gf256_eliminate as jax_gf256_eliminate
from ldpc_erasure_codes_tpu.ops.pallas_nbmm import (
    gf_apply_scatter as jax_gf_apply_scatter,
    gf_matmul_batched as jax_gf_matmul_batched,
    gf_matvec_wide as jax_gf_matvec_wide,
)
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.compact import compact_ge_solve
from ldpc_erasure_codes_tpu_torch.ops.elim import gf256_eliminate, gf256_eliminate_reference
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import _syndrome_known, ge_solve, ge_solve_wide_nb
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    gf_apply_scatter,
    gf_matmul_batched,
    gf_matmul_batched_reference,
    gf_matvec_tiles_reference,
    gf_matvec_wide,
    gf_matvec_wide_reference,
    matrix_rows,
    matrix_tiles,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from torch_port_cases import small_jax_code, to_port_code


def _nb_cube(seed, cut):
    """tests/test_pallas_elim.py::test_nb_matches_reference_elimination
    (and, with ``cut``, ::test_nb_a_words_cuts_are_exact): (C, m, B) words."""
    rng = np.random.default_rng(seed)
    c, m, b, emax = 6, 16, 128, 20
    r = rng.integers(0, 1 << 32, (c, m, b), dtype=np.uint32)
    r &= rng.integers(0, 1 << 32, (c, m, b), dtype=np.uint32)
    r[:, 14:, :] = 0
    nreal = rng.integers(0, emax + 1, b).astype(np.int32)
    if cut:
        nreal[:3] = [0, 7, 20]
        for f in range(b):  # A bytes >= nreal are zero (pad columns)
            for col in range(int(nreal[f]), emax):
                r[col >> 2, :, f] &= ~np.uint32(0xFF << (8 * (col & 3)))
    else:
        r[:, :, :2] = 0
    return r, nreal, emax, (-(-emax // 4) if cut else 0)


@pytest.mark.parametrize("cut", [False, True], ids=["a_words_0", "a_words_wa"])
def test_gf256_eliminate_matches_pallas(cut):
    r, nreal, emax, a_words = _nb_cube(5 if cut else 2, cut)
    j_r, j_piv, j_fail = (np.asarray(x) for x in jax_gf256_eliminate(
        jnp.asarray(r), jnp.asarray(nreal[None]), emax=emax, b_tile=128, interpret=True,
        a_words=a_words,
    ))
    cube = torch.from_numpy(np.ascontiguousarray(np.transpose(r, (2, 1, 0))).view(np.int32))
    before = gf256_eliminate.launches
    p_r, p_piv, p_fail = gf256_eliminate(cube, torch.from_numpy(nreal), emax=emax,
                                         a_words=a_words)
    assert gf256_eliminate.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(p_piv.numpy(), j_piv.T)
    np.testing.assert_array_equal(p_fail.numpy(), j_fail[0] != 0)
    np.testing.assert_array_equal(p_r.numpy().view(np.uint32), np.transpose(j_r, (2, 1, 0)))
    assert p_fail.any() and not p_fail.all()
    if cut:  # the cuts change no pivot, no flag, no solved frame's cube
        base = gf256_eliminate_reference(cube, torch.from_numpy(nreal), emax=emax)
        assert torch.equal(base[1], p_piv) and torch.equal(base[2], p_fail)
        assert torch.equal(base[0][~p_fail], p_r[~p_fail])


@pytest.mark.parametrize("b,n,w,m,density", [(3, 255, 256, 63, 1.0), (2, 96, 128, 32, 0.1)])
def test_gf_matvec_wide_matches_pallas(b, n, w, m, density):
    """Dense (the RS H) and sparse (an LDPC H) matrices; the Pallas kernel
    takes the bit image of the same byte matrix."""
    rng = np.random.default_rng(b)
    y = rng.integers(0, 256, (b, n, w), dtype=np.uint8)
    mat = rng.integers(0, 256, (n, m), dtype=np.uint8)
    mat[rng.random((n, m)) >= density] = 0
    want = np.asarray(jax_gf_matvec_wide(
        jnp.asarray(y), jax_ge._bit_image_dev(jnp.asarray(mat)), interpret=True,
        out_layout="mw"))[:, :m]
    idx, coef = matrix_rows(torch.from_numpy(mat))
    assert idx.shape[1] == max(1, int((mat != 0).sum(axis=0).max()))
    before = gf_matvec_wide.launches
    got = gf_matvec_wide(torch.from_numpy(y), idx, coef)
    assert gf_matvec_wide.launches == before
    assert got.dtype == torch.uint8 and got.shape == (b, m, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gf_matvec_wide_on_the_vlist_is_the_syndrome():
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(8)
    y = rng.integers(0, 256, (2, code.n, 8), dtype=np.uint8)
    y[rng.random((2, code.n)) < 0.2] = 0
    y = torch.from_numpy(y)
    got = gf_matvec_wide(y, arrays.vlist_idx, arrays.vlist_val)
    words = _syndrome_known(arrays, y.view(torch.int32))
    np.testing.assert_array_equal(got.numpy(), words.view(torch.uint8).numpy())
    idx, coef = matrix_rows(arrays.h_nb.t().contiguous())  # the same H as lists
    assert torch.equal(gf_matvec_wide(y, idx, coef), got)


@pytest.mark.parametrize("n,m,density,tiled", [
    (255, 63, 1.0, True), (120, 100, 0.6, True), (40, 9, 1.0, True), (96, 32, 0.1, False),
])
def test_matrix_tiles_match_pallas(n, m, density, tiled):
    """The dense route's tiles (``matrix_tiles``) and their plain product
    against the Pallas kernel: one tile of 64 rows (the RS shape), two
    tiles, a 16-row tile; a sparse matrix is left to the list route."""
    rng = np.random.default_rng(n + m)
    y = rng.integers(0, 256, (2, n, 8), dtype=np.uint8)
    mat = rng.integers(0, 256, (n, m), dtype=np.uint8)
    mat[rng.random((n, m)) >= density] = 0
    want = np.asarray(jax_gf_matvec_wide(
        jnp.asarray(y), jax_ge._bit_image_dev(jnp.asarray(mat)), interpret=True,
        out_layout="mw"))[:, :m]
    tiles = matrix_tiles(*matrix_rows(torch.from_numpy(mat)), n)
    assert (tiles is not None) == tiled
    if not tiled:
        return
    assert tiles.rows == (16 if m <= 16 else 64) and tiles.cols.shape[0] == -(-m // tiles.rows)
    for t in range(tiles.cols.shape[0]):
        cols = tiles.cols[t, : int(tiles.ncols[t])]
        assert bool((cols[1:] > cols[:-1]).all())
    np.testing.assert_array_equal(gf_matvec_tiles_reference(torch.from_numpy(y), tiles).numpy(),
                                  want)


def test_matrix_tiles_of_code_lists():
    """The RS(255,192) Vlist tiles into one 64-row tile and equals the list
    product, with repeated and out-of-range entries added to its lists;
    the (2040,1530) GF(256) Vlist is sparse (None: the list route)."""
    from ldpc_erasure_codes_tpu_torch.rs import rs_code

    arrays = code_arrays(rs_code(255, 192), "cpu")
    assert code_arrays(get_code("n2040_k1530_gf256"), "cpu").vlist_tiles is None
    idx = torch.cat([arrays.vlist_idx, arrays.vlist_idx[:, :2], torch.full((63, 1), -1),
                     torch.full((63, 1), 300)], dim=1).to(torch.int32).contiguous()
    coef = torch.cat([arrays.vlist_val, torch.tensor([[7, 0xFF]]).expand(63, 2).to(torch.uint8),
                      torch.full((63, 2), 5, dtype=torch.uint8)], dim=1).contiguous()
    y = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (3, 255, 12), dtype=np.uint8))
    for i, c in ((arrays.vlist_idx, arrays.vlist_val), (idx, coef)):
        tiles = matrix_tiles(i, c, 255)
        assert tiles.rows == 64 and int(tiles.ncols[0]) == 255
        assert torch.equal(gf_matvec_tiles_reference(y, tiles), gf_matvec_wide_reference(y, i, c))
    assert torch.equal(gf_matvec_tiles_reference(y, arrays.vlist_tiles),
                       gf_matvec_wide(y, arrays.vlist_idx, arrays.vlist_val))


def test_gf_apply_scatter_matches_pallas():
    """tests/test_pallas_nbmm.py::test_apply_scatter_matches_separate: solved
    rows land at their targets, dump-row targets (>= n) are dropped, other
    rows pass through."""
    rng = np.random.default_rng(11)
    b, n_pad, m_pad, e_pad, w = 3, 64, 16, 16, 256
    emax, n_real = 10, 60
    values = rng.integers(0, 256, (b, n_pad, w), dtype=np.uint8)
    values[:, n_real:, :] = 0
    rhs = rng.integers(0, 256, (b, m_pad, w), dtype=np.uint8)
    mats = rng.integers(0, 256, (b, e_pad, m_pad), dtype=np.uint8)
    idx = np.stack([
        np.concatenate([rng.choice(n_real, size=emax - 2, replace=False),
                        np.full(e_pad - (emax - 2), n_real)])
        for _ in range(b)
    ]).astype(np.int32)
    for f in range(b):
        values[f, idx[f, : emax - 2]] = 0  # erased slots are zero
    want = np.asarray(jax_gf_apply_scatter(
        jnp.asarray(values), jnp.asarray(rhs), jnp.asarray(mats), jnp.asarray(idx),
        interpret=True))[:, :n_real]
    before = gf_apply_scatter.launches
    got = gf_apply_scatter(torch.from_numpy(values[:, :n_real].copy()), torch.from_numpy(rhs),
                           torch.from_numpy(mats), torch.from_numpy(idx))
    assert gf_apply_scatter.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_gf_matmul_batched_matches_pallas():
    """tests/test_pallas_nbmm.py::test_matmul_batched_matches_xla: the padded
    operands (m_pad 64, e_pad 56) give the TPU kernel's padded product, and
    the unpadded ones its top-left block; the rows placed by
    gf_apply_scatter are these rows."""
    rng = np.random.default_rng(7)
    b, m, e, w = 3, 63, 50, 256
    m_pad, e_pad = 64, 56
    rhs = rng.integers(0, 256, (b, m_pad, w), dtype=np.uint8)
    rhs[:, m:, :] = 0
    mats = np.pad(rng.integers(0, 256, (b, e, m), dtype=np.uint8),
                  ((0, 0), (0, e_pad - e), (0, m_pad - m)))
    want = np.asarray(jax_gf_matmul_batched(jnp.asarray(rhs), jnp.asarray(mats), interpret=True))
    before = gf_matmul_batched.launches
    got = gf_matmul_batched(torch.from_numpy(rhs), torch.from_numpy(mats))
    assert gf_matmul_batched.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    rows = gf_matmul_batched_reference(torch.from_numpy(rhs[:, :m].copy()),
                                       torch.from_numpy(mats[:, :e, :m].copy()))
    np.testing.assert_array_equal(rows.numpy(), want[:, :e])
    idx = torch.from_numpy(np.stack([rng.permutation(e) for _ in range(b)]).astype(np.int32))
    placed = gf_apply_scatter(torch.zeros((b, e, w), dtype=torch.uint8), torch.from_numpy(rhs),
                              torch.from_numpy(mats[:, :e].copy()), idx)
    frames = torch.arange(b)[:, None]
    assert torch.equal(placed[frames, idx.long()], rows)


@functools.cache
def _small():
    """The small generated code (n=48, k=32; every column of degree 2)
    lifted to GF(256) on the JAX side, and its port copy."""
    jcode = small_jax_code().lift_to_gf256(seed=0)
    return jcode, to_port_code(jcode)


def _frames(code, b, wb, per, seed, peel_iters=None):
    """(codewords, received values with erased slots zero, mask), uint8,
    encoded by the port (equal to the JAX encode, tests/test_torch_nb.py);
    with ``peel_iters`` the values and mask after that many peel sweeps."""
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, 256, (b, code.k, wb), dtype=np.uint8))
    cw = encode_packed(arrays, src, gf_order=256)
    mask = torch.from_numpy(rng.random((b, code.n)) < per)
    values = cw.masked_fill(mask[:, :, None], 0)
    if peel_iters is not None:
        values, mask, _ = peel_decode(arrays, values, mask, max_iters=peel_iters, gf_order=256)
    return cw.numpy(), values, mask


def _assert_solver_equal(got, want, cw=None):
    """(values, erased, failed) against the JAX triple; values compared on
    frames that did not fail (and against the codewords there)."""
    v, e, f = (x.numpy() for x in got)
    jv, je, jf = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(v[~f], jv[~jf])
    if cw is not None:
        np.testing.assert_array_equal(v[~f], cw[~f])


@pytest.mark.parametrize("code_name,b,per,emax", [
    ("small", 8, 0.2, 16), ("small", 8, 0.28, 14), ("n2040_k1530_gf256", 4, 0.03, 96),
])
def test_ge_solvers_match_jax(code_name, b, per, emax):
    """ge_solve (the byte GE with row swaps) and ge_solve_wide_nb (the three
    kernels' path) against JAX's ge_solve and ge_solve_wide_nb: pure GE on
    the channel's erasures, solved, rank-deficient and overflowing frames."""
    if code_name == "small":
        jcode, code = _small()
    else:
        jcode, code = jax_get_code(code_name), get_code(code_name)
    cw, values, mask = _frames(code, b, 8, per, seed=len(code_name) + b)
    arrays = code_arrays(code, "cpu")
    jarr = device_arrays(jcode)
    want = jax_ge.ge_solve(jarr, jnp.asarray(values.numpy()), jnp.asarray(mask.numpy()),
                           emax=emax, gf_order=256)
    got = ge_solve(arrays, values, mask, emax=emax, gf_order=256)
    _assert_solver_equal(got, want, cw)
    want_w = jax_ge.ge_solve_wide_nb(jarr, jnp.asarray(values.numpy()),
                                     jnp.asarray(mask.numpy()), emax=emax)
    counts = (gf256_eliminate.launches, gf_matvec_wide.launches, gf_apply_scatter.launches)
    got_w = ge_solve_wide_nb(arrays, values, mask, emax=emax)
    assert counts == (gf256_eliminate.launches, gf_matvec_wide.launches,
                      gf_apply_scatter.launches)
    _assert_solver_equal(got_w, want_w, cw)
    _assert_solver_equal(got_w, got)
    failed = got[2].numpy()
    if code_name == "small":
        assert failed.any() and not failed.all()  # both kinds of frame occur
    else:
        assert not failed.any()


def test_compact_ge_solve_nb_matches_jax():
    jcode, code = _small()
    cw, values, mask = _frames(code, 16, 8, 0.3, seed=21, peel_iters=2)
    assert 4 < int(mask.any(dim=1).sum()) < 16
    want = jax_compact.compact_ge_solve(
        device_arrays(jcode), jnp.asarray(values.numpy()), jnp.asarray(mask.numpy()),
        emax=32, f_max=4, gf_order=256)
    got = compact_ge_solve(code_arrays(code, "cpu"), values, mask, emax=32, f_max=4,
                           gf_order=256)
    _assert_solver_equal(got, want, cw)
    assert got[2].any()  # the bucket overflowed


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("ge_subbatch", [0, 6])
def test_hybrid_nb_matches_jax(tiled, ge_subbatch):
    """hybrid_decode(gf_order=256): ``tiled`` takes no binary row branch
    (hybrid.py:158-162), so both settings equal JAX's flat decode. JAX runs
    the peel kernel (interpret mode) with one-frame tiles, which stop per
    frame as the port's peel does."""
    jcode, code = _small()
    cw, values, mask = _frames(code, 16, 8, 0.32, seed=31)
    kw = dict(gf_order=256, peel_iters=3, emax=24, ge_subbatch=ge_subbatch)
    jv, je, jit, jf, jov = (np.asarray(x) for x in jax_hybrid.hybrid_decode(
        device_arrays(jcode), jnp.asarray(values.numpy()), jnp.asarray(mask.numpy()),
        impl="vmem", b_tile=1, return_overflow=True, **kw))
    v, e, it, f, ov = (x.numpy() for x in hybrid_decode(
        code_arrays(code, "cpu"), values, mask, tiled=tiled, return_overflow=True, impl="vmem",
        **kw))
    np.testing.assert_array_equal(it, jit)
    np.testing.assert_array_equal(ov, jov)
    _assert_solver_equal([torch.from_numpy(x) for x in (v, e, f)], (jv, je, jf), cw)
    assert not f.all() and (mask.numpy() & ~e).any()


def test_hybrid_escalated_nb_matches_jax():
    """Buckets too small for the batch: escalation re-solves the overflowed
    frames with ge_solve_wide_nb, as JAX does (hybrid.py:294-295)."""
    jcode, code = _small()
    cw, values, mask = _frames(code, 16, 8, 0.35, seed=41)
    kw = dict(gf_order=256, peel_iters=2, emax=6, ge_subbatch=4)
    jv, je, jit, jf, jn = jax_hybrid.hybrid_decode_escalated(
        device_arrays(jcode), jnp.asarray(values.numpy()), jnp.asarray(mask.numpy()),
        impl="vmem", b_tile=1, **kw)
    arrays = code_arrays(code, "cpu")
    first = hybrid_decode(arrays, values, mask, impl="vmem", **kw)
    counts = gf256_eliminate.launches
    v, e, it, f, n_esc = hybrid_decode_escalated(arrays, values, mask, impl="vmem", **kw)
    assert gf256_eliminate.launches == counts
    assert n_esc == jn > 0
    assert int(first[3].sum()) > int(f.sum())  # escalation solved frames
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    _assert_solver_equal((v, e, f), (jv, je, jf), cw)


def test_ge_solve_binary_matches_jax():
    """ge_solve with gf_order=2 on int32 words (the coefficients are ones)
    against JAX's byte GE on the same uint32 frames."""
    jcode = small_jax_code()
    code = to_port_code(jcode)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(51)
    src = torch.from_numpy(rng.integers(0, 2**32, (8, code.k, 3), dtype=np.uint32).view(np.int32))
    cw = encode_packed(arrays, src)
    mask = torch.from_numpy(rng.random((8, code.n)) < 0.25)
    values = cw.masked_fill(mask[:, :, None], 0)
    want = jax_ge.ge_solve(device_arrays(jcode), jnp.asarray(values.numpy().view(np.uint32)),
                           jnp.asarray(mask.numpy()), emax=16)
    got = ge_solve(arrays, values, mask, emax=16)
    v, e, f = (x.numpy() for x in got)
    np.testing.assert_array_equal(f, np.asarray(want[2]))
    np.testing.assert_array_equal(e, np.asarray(want[1]))
    np.testing.assert_array_equal(v.view(np.uint32)[~f], np.asarray(want[0])[~f])
    np.testing.assert_array_equal(v[~f], cw.numpy()[~f])
    assert f.any() and not f.all()
