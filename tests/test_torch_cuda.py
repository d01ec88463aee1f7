"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one. The
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Kernels and plain versions are compared bit for bit (tolerance 0: the
operations are XORs and flag updates, with no rounding).
"""

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import channel, elim, nbmm, peel, rank, synd
from ldpc_erasure_codes_tpu_torch.ops import encode as enc
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, pack_bits
from ldpc_erasure_codes_tpu_torch.ops.encode import encode, encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check, ge_rank_check_reference, ge_solve_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    peel_decode_jacobi,
    peel_decode_jacobi_reference,
    peel_decode_mask,
)
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo, syndrome_from_topo_reference
from ldpc_erasure_codes_tpu_torch.utils import golden, verify
from torch_port_cases import (  # noqa: F401 (fixture)
    cuda_device,
    random_words,
    rank_edge_masks,
    to_torch,
)

pytestmark = pytest.mark.cuda


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data pointer is 4 bytes past a
    16-byte boundary (the kernels' one-word path)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (3, True)])
def test_encode_kernel_matches_plain(cuda_device, w, aligned):
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, cuda_device)
    src = to_torch(random_words(np.random.default_rng(3), (8, code.k, w))).to(cuda_device)
    if not aligned:
        src = _misaligned(src)
    before = encode_packed.launches
    got = encode_packed(arrays, src)
    torch.cuda.synchronize()
    assert encode_packed.launches == before + 1
    torch.testing.assert_close(got, encode_packed_reference(arrays, src), rtol=0, atol=0)


SHIPPED = ("n2040_k1530", "n2000_k1000", "n4000_k2000", "n4080_k3060")


def _slab_cases():
    """(name, gf_order, w, aligned, Wc (None: the wrapper's choice), B):
    every shipped code in both fields at the wrapper's Wc with W = 250
    (ragged), 3 and misaligned; B = 1 at W = 8; then each Wc that fits
    (from the host's size arithmetic, no card needed) at (2040,1530) and
    (4080,3060)."""
    cases = [(name, gf, w, aligned, None, b)
             for name in SHIPPED for gf in (2, 256)
             for w, aligned, b in ((250, True, 5), (3, True, 5), (256, False, 5), (8, True, 1))]
    for name in ("n2040_k1530", "n4080_k3060"):
        arrays = code_arrays(get_code(name), "cpu")
        for gf in (2, 256):
            cases += [(name, gf, 64, True, wc, 3) for wc in enc.SLAB_WORDS
                      if enc.slab_smem(arrays, wc, gf) <= peel.SMEM_LIMIT]
    return cases


def _source(code, gf_order, b, w, rng, dev):
    if gf_order == 256:
        return torch.from_numpy(rng.integers(0, 256, (b, code.k, 4 * w), dtype=np.uint8)).to(dev)
    return to_torch(random_words(rng, (b, code.k, w))).to(dev)


@pytest.mark.parametrize("name,gf_order,w,aligned,wc,b", _slab_cases())
def test_encode_slab_kernel_matches_plain(cuda_device, name, gf_order, w, aligned, wc, b):
    """The slab route (levels of parity rows out of a shared-memory slab)
    against the row-by-row plain version; every shipped code takes it."""
    code = get_code(name if gf_order == 2 else f"{name}_gf256")
    arrays = code_arrays(code, cuda_device)
    assert enc.slab_words(arrays, w, gf_order) is not None
    src = _source(code, gf_order, b, w, np.random.default_rng(w + b), cuda_device)
    if not aligned:
        src = _misaligned_bytes(src) if gf_order == 256 else _misaligned(src)
    counter = "launches_gf256" if gf_order == 256 else "launches"
    before = getattr(encode_packed, counter)
    if wc is None:
        got = encode_packed(arrays, src, gf_order=gf_order)
    else:
        words = src.view(torch.int32) if gf_order == 256 else src
        got = enc.launch_slab(arrays, words, gf_order, wc)
        got = got.view(torch.uint8) if gf_order == 256 else got
    torch.cuda.synchronize()
    assert getattr(encode_packed, counter) == before + 1
    torch.testing.assert_close(got, encode_packed_reference(arrays, src, gf_order=gf_order),
                               rtol=0, atol=0)


@pytest.mark.parametrize("gf_order", [2, 256])
@pytest.mark.parametrize("w,aligned", [(256, True), (5, True), (256, False)])
def test_encode_warp_route_matches_plain(cuda_device, gf_order, w, aligned):
    """The per-warp route, which codes whose slab does not fit take."""
    code = get_code("n2040_k1530" if gf_order == 2 else "n2040_k1530_gf256")
    arrays = code_arrays(code, cuda_device)
    src = _source(code, gf_order, 4, w, np.random.default_rng(w), cuda_device)
    if not aligned:
        src = _misaligned_bytes(src) if gf_order == 256 else _misaligned(src)
    words = src.view(torch.int32) if gf_order == 256 else src
    got = enc.launch_warp(arrays, words, gf_order)
    torch.cuda.synchronize()
    want = encode_packed_reference(arrays, src, gf_order=gf_order)
    torch.testing.assert_close(got, want.view(torch.int32) if gf_order == 256 else want,
                               rtol=0, atol=0)


def test_encode_slab_wrapper_refuses_blocks_over_shared_memory(cuda_device):
    arrays = code_arrays(get_code("n4080_k3060"), cuda_device)
    src = torch.zeros((1, 3060, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="Wc must be"):
        enc.launch_slab(arrays, src, 2, 16)


# (name, early_stop, w, aligned, Wc (None: the wrapper's choice), B, edge
# frames): the two codes at the default Wc; (4080,3060) at the largest Wc
# that fits (8 words, 195 KB with the staged tables); W not a multiple of Wc; the one-word path
# (misaligned) at Wc 16; B = 1; all-erased and none-erased frames at Wc 4.
PEEL_CASES = [
    (name, early_stop, w, aligned, None, 16, False)
    for name in ("n2040_k1530", "n4000_k2000") for early_stop in (False, True)
    for w, aligned in ((256, True), (256, False), (5, True))
] + [
    ("n4080_k3060", False, 256, True, 8, 16, False),
    ("n4080_k3060", True, 256, True, 8, 16, False),
    ("n2040_k1530", False, 200, True, 12, 16, False),
    ("n2040_k1530", True, 20, True, 8, 16, False),
    ("n2040_k1530", False, 256, False, 16, 16, False),
    ("n2040_k1530", True, 256, True, None, 1, False),
    ("n2040_k1530", False, 64, True, 4, 16, True),
]


@pytest.mark.parametrize("name,early_stop,w,aligned,wc,b,edges", PEEL_CASES)
def test_peel_kernel_matches_plain(cuda_device, name, early_stop, w, aligned, wc, b, edges):
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(7)
    src = to_torch(random_words(rng, (b, code.k, w))).to(cuda_device)
    cw = encode_packed(arrays, src)
    cw[0, 0, 0] ^= 1  # frame 0 is not a codeword
    if not aligned:
        cw = _misaligned(cw)
    mask = torch.from_numpy(rng.random((b, code.n)) < 0.1406).to(cuda_device)
    if edges:
        mask[1], mask[2] = True, False
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None)
    k_stop = code.n if kw["early_stop_k"] is None else code.k
    before = peel_decode.launches
    if wc is None:
        got = peel_decode(arrays, cw, mask, **kw)
    else:
        got = peel.launch_kernel(arrays, cw, mask, k_stop, 50, 2, wc)
    torch.cuda.synchronize()
    assert peel_decode.launches == before + 1
    for g, r in zip(got, peel_decode_reference(arrays, cw, mask, **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("name,per,max_iters", [
    ("n2040_k1530", 0.1406, 50), ("n2040_k1530", 0.3, 10), ("n4080_k3060", 0.2, 50)])
@pytest.mark.parametrize("early_stop", [False, True])
def test_peel_schedule_kernel_matches_plain(cuda_device, name, per, max_iters, early_stop):
    """The schedule kernel alone: the level-sorted resolutions, level
    offsets, level counts, erased flags and iteration counts."""
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    mask = torch.from_numpy(np.random.default_rng(5).random((16, code.n)) < per)
    mask[1], mask[2] = True, False
    mask = mask.to(cuda_device)
    esk = code.k if early_stop else None
    got = peel.launch_schedule(arrays, mask, code.k if early_stop else code.n, max_iters)
    torch.cuda.synchronize()
    want = peel.peel_schedule_reference(arrays, mask, max_iters=max_iters, early_stop_k=esk)
    _equal(got, want)


_ORDER_PLAIN = {"grouped": peel.grouped_schedule_reference,
                "jacobi": peel.jacobi_schedule_reference,
                "counted": peel.counted_schedule_reference}


@pytest.mark.parametrize("schedule", ["grouped", "jacobi", "counted"])
@pytest.mark.parametrize("name,per,max_iters", [
    ("n2040_k1530", 0.1406, 50), ("n2040_k1530", 0.3, 10), ("n4080_k3060", 0.2, 50),
    ("n4000_k2000", 0.3, 50)])
@pytest.mark.parametrize("early_stop", [False, True])
def test_schedule_kernel_orders_match_plain(cuda_device, schedule, name, per, max_iters,
                                            early_stop):
    """The schedule kernel alone in its grouped, Jacobi and counted visit
    orders, against their plain versions on every output; the grouped and
    counted orders' outputs equal the check-by-check order's (the seq
    schedule kernel)."""
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    mask = torch.from_numpy(np.random.default_rng(5).random((16, code.n)) < per)
    mask[1], mask[2] = True, False
    mask = mask.to(cuda_device)
    esk = code.k if early_stop else None
    k_stop = code.k if early_stop else code.n
    got = peel.launch_schedule(arrays, mask, k_stop, max_iters, schedule)
    torch.cuda.synchronize()
    _equal(got, _ORDER_PLAIN[schedule](arrays, mask, max_iters=max_iters, early_stop_k=esk))
    if schedule != "jacobi":
        _equal(got, peel.launch_schedule(arrays, mask, k_stop, max_iters, "seq"))


def _shared_slot_frames(arrays, mask):
    """``mask`` with frame f >= 3 (up to 8) erasing one symbol of column
    degree >= 2 alone, so that its checks all solve it in the first
    sweep."""
    deg = arrays.clist_len.cpu()
    syms = (deg >= 2).nonzero().squeeze(1)
    for f in range(3, min(8, mask.shape[0])):
        mask[f] = False
        mask[f, int(syms[(37 * f) % len(syms)])] = True
    return mask


@pytest.mark.parametrize("gf_order", [2, 256])
@pytest.mark.parametrize("early_stop", [False, True])
def test_jacobi_route_on_random_words_with_shared_slots(cuda_device, gf_order, early_stop):
    """The Jacobi route on random words (no codeword, so the checks that
    solve one symbol in one sweep give different values): equal to its
    plain version on every output, the highest-numbered check's value kept;
    frames 3..7 erase a single symbol that all its checks solve at once."""
    name = "n2040_k1530" if gf_order == 2 else "n2040_k1530_gf256"
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(23)
    if gf_order == 2:
        vals = to_torch(random_words(rng, (16, code.n, 64))).to(cuda_device)
    else:
        vals = _random_bytes(rng, (16, code.n, 256), cuda_device)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.1406)
    mask = _shared_slot_frames(arrays, mask).to(cuda_device)
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None, gf_order=gf_order)
    counter = "launches_jacobi" + ("_gf256" if gf_order == 256 else "")
    before = getattr(peel_decode, counter)
    got = peel_decode(arrays, vals, mask, schedule="jacobi", **kw)
    torch.cuda.synchronize()
    assert getattr(peel_decode, counter) == before + 1
    _equal(got, peel_decode_jacobi_reference(arrays, vals, mask, **kw))


def test_peel_wrapper_refuses_slabs_over_shared_memory(cuda_device):
    """A slab of n x 4 words with the staged tables above a block's shared
    memory raises; so does a Wc whose slab does not fit (16 words at
    n = 4080)."""
    arrays = code_arrays(get_code("n2000_k1000"), cuda_device)
    n = peel.SMEM_LIMIT // 20
    vals = torch.zeros((1, n, 4), dtype=torch.int32, device=cuda_device)
    er = torch.zeros((1, n), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory limit"):
        peel_decode(arrays, vals, er)
    big = code_arrays(get_code("n4080_k3060"), cuda_device)
    vals = torch.zeros((1, 4080, 16), dtype=torch.int32, device=cuda_device)
    er = torch.zeros((1, 4080), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="Wc must be"):
        peel.launch_kernel(big, vals, er, 4080, 50, 2, 16)


def test_wrappers_refuse_mixed_devices(cuda_device):
    code = get_code("n2000_k1000")
    cpu_arrays = code_arrays(code, "cpu")
    src = torch.zeros((2, code.k, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        encode_packed(cpu_arrays, src)
    vals = torch.zeros((2, code.n, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        peel_decode(cpu_arrays, vals, torch.zeros((2, code.n), dtype=torch.bool))


def _equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _random_cube(rng, b, m, c, emax, zero_pad_columns):
    """Sparse random packed systems: a third of the frames have no rows
    below m - 4 (pad-style zero rows), two frames are all zero (they fail);
    nreal random, with A bits past nreal zeroed where the solver would."""
    r = rng.integers(0, 2**32, (b, m, c), dtype=np.uint32)
    r &= rng.integers(0, 2**32, (b, m, c), dtype=np.uint32)
    r[: b // 3, m - 4 :] = 0
    r[-2:] = 0
    nreal = rng.integers(0, emax + 1, b).astype(np.int32)
    if zero_pad_columns:
        cols = np.arange(32 * c)
        keep = (cols[None, :] < nreal[:, None]) | (cols[None, :] >= emax)  # (B, 32C)
        words = np.packbits(keep, axis=1, bitorder="little").view(np.uint32)  # (B, C)
        r &= words[:, None, :]
    return to_torch(r), torch.from_numpy(nreal)


def _zero_panels(cube):
    """Zero word 0 of frame 0 and word 1 of frame 1 in every row: panels
    the kernel skips, in front of and between live ones."""
    cube[0, :, 0] = 0
    if cube.shape[0] > 1 and cube.shape[2] > 1:
        cube[1, :, 1] = 0
    return cube


@pytest.mark.parametrize("in_smem", [True, False], ids=["smem", "device_memory"])
@pytest.mark.parametrize("a_words", [False, True], ids=["a_words_0", "a_words_wa"])
@pytest.mark.parametrize("b,m,c,emax", [(64, 510, 32, 512), (16, 1000, 56, 768), (3, 40, 3, 40),
                                        (8, 200, 10, 96), (1, 510, 32, 512), (5, 70, 4, 40)])
def test_eliminate_kernel_matches_plain(cuda_device, in_smem, a_words, b, m, c, emax):
    """Both modes of the kernel, with and without the a_words cuts, at the
    (2040,1530) and (2000,1000) GE cubes (65 KB and 224 KB per frame), at
    B = 1, and with a partial last panel (emax 40, 96); frames 0 and 1 hold
    a panel that is zero in every row, and the last two are all zero."""
    rng = np.random.default_rng(m + c)
    wa = -(-emax // 32)
    cube, nreal = _random_cube(rng, b, m, c, emax, zero_pad_columns=a_words)
    cube, nreal = _zero_panels(cube).to(cuda_device), nreal.to(cuda_device)
    aw = wa if a_words else 0
    if in_smem:
        assert elim.fits_shared_memory(m, c)
    before = elim.f2_eliminate.launches
    got = elim.launch_kernel(cube, nreal, emax, aw, in_smem)
    torch.cuda.synchronize()
    assert elim.f2_eliminate.launches == before + 1
    want = elim.f2_eliminate_reference(cube, nreal, emax=emax, a_words=aw)
    _equal(got, want)
    _equal(got, elim.f2_eliminate_panels_reference(cube, nreal, emax=emax, a_words=aw))
    if b >= 16:  # solved and failed frames both occur
        assert want[2].any() and not want[2].all()


@pytest.mark.parametrize("b", [3, 1])
def test_eliminate_device_memory_mode_at_4000(cuda_device, b):
    """(4000,2000) at emax 1024: 2000 rows x 95 words do not fit in shared
    memory, so the wrapper takes the device-memory mode; with zero panels
    and at B = 1."""
    m, c, emax = 2000, 32 + 63, 1024
    assert not elim.fits_shared_memory(m, c)
    cube, nreal = _random_cube(np.random.default_rng(40), b, m, c, emax, zero_pad_columns=True)
    cube, nreal = _zero_panels(cube).to(cuda_device), nreal.to(cuda_device)
    got = elim.f2_eliminate(cube, nreal, emax=emax, a_words=emax // 32)
    torch.cuda.synchronize()
    _equal(got, elim.f2_eliminate_reference(cube, nreal, emax=emax, a_words=emax // 32))


SYND_ROUTES = {"auto": syndrome_from_topo, "list": synd.launch_list, "walk": synd.launch_walk}


@pytest.mark.parametrize("route", list(SYND_ROUTES))
@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (5, True), (3, True)])
def test_syndrome_kernel_matches_plain(cuda_device, w, aligned, route):
    """Both routes, forced, and the wrapper's choice (the list route at
    every W here); each counts one launch of ``syndrome_from_topo`` and
    none of ``f2_matvec_wide``."""
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(w)
    v = random_words(rng, (8, code.n, w))
    v[rng.random((8, code.n)) < 0.2] = 0
    values = to_torch(v).to(cuda_device)
    if not aligned:
        values = _misaligned(values)
    assert synd.synd_route(code.n, code.m, arrays.dmax, w) == "list"
    before = (syndrome_from_topo.launches, nbmm.f2_matvec_wide.launches)
    got = SYND_ROUTES[route](arrays, values)
    torch.cuda.synchronize()
    assert (syndrome_from_topo.launches, nbmm.f2_matvec_wide.launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got, syndrome_from_topo_reference(arrays, values), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["n2040_k1530", "n4000_k2000"])
@pytest.mark.parametrize("wc", nbmm.F2_SLAB_WORDS)
def test_syndrome_list_route_every_slab_width(cuda_device, name, wc):
    """The list route at each slab width Wc whose block fits (from the
    host's size arithmetic), B = 3, W = 64; a Wc over shared memory
    raises."""
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(wc)
    values = to_torch(random_words(rng, (3, code.n, 64))).to(cuda_device)
    if nbmm.f2_rows_smem(code.n, code.m, arrays.dmax, wc) > nbmm.SMEM_LIMIT:
        with pytest.raises(ValueError):
            synd.launch_list(arrays, values, wc)
        return
    got = synd.launch_list(arrays, values, wc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, syndrome_from_topo_reference(arrays, values), rtol=0, atol=0)


@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (5, True), (3, True)])
@pytest.mark.parametrize("k,e", [(510, 512), (1000, 768), (40, 9)])
def test_f2mm_kernels_match_plain(cuda_device, w, aligned, k, e):
    """matmul_batched and apply_scatter at the GE transform shapes, and
    matvec with a dense random H; bits past K are set in the matrices and
    must be ignored."""
    rng = np.random.default_rng(k + w)
    b, n = 4, 2 * k
    kw = -(-k // 32)
    dev = cuda_device
    rhs = to_torch(random_words(rng, (b, k, w))).to(dev)
    t = to_torch(random_words(rng, (b, e, kw))).to(dev)
    values = to_torch(random_words(rng, (b, n, w))).to(dev)
    if not aligned:
        rhs, values = _misaligned(rhs), _misaligned(values)
    idx = np.stack([rng.permutation(n + 8)[:e] for _ in range(b)]).astype(np.int32)
    idx[0, :3] = [-1, n, n + 100]  # dropped targets
    idx = torch.from_numpy(idx).to(dev)
    h = to_torch(random_words(rng, (k, -(-n // 32)))).to(dev)
    assert nbmm.f2_slab_words(nbmm.f2_matrix_rows(h, n)[0], n, w) is None  # the bit scan
    counts = [nbmm.f2_matmul_batched.launches, nbmm.f2_apply_scatter.launches,
              nbmm.f2_matvec_wide.launches]
    got = (nbmm.f2_matmul_batched(rhs, t), nbmm.f2_apply_scatter(values, rhs, t, idx),
           nbmm.f2_matvec_wide(values, h))
    torch.cuda.synchronize()
    assert [nbmm.f2_matmul_batched.launches, nbmm.f2_apply_scatter.launches,
            nbmm.f2_matvec_wide.launches] == [c + 1 for c in counts]
    want = (nbmm.f2_matmul_batched_reference(rhs, t),
            nbmm.f2_apply_scatter_reference(values, rhs, t, idx),
            nbmm.f2_matvec_wide_reference(values, h))
    _equal(got, want)


def _apply_cases():
    """(k, e, w, aligned, placed share, Wc (None: the wrapper's choice)):
    the (2040,1530) GE bucket's shape with 37% of the rows placed and with
    1% (most frames none); W = 3 and 5, misaligned; each Wc that fits."""
    cases = [(510, 512, 256, True, 0.37, None), (510, 512, 256, True, 0.01, None),
             (510, 512, 256, False, 0.37, None), (510, 512, 5, True, 0.37, None),
             (510, 512, 3, True, 0.01, None), (1000, 768, 64, True, 0.37, None),
             (40, 9, 5, False, 0.37, None), (2000, 1024, 32, True, 0.1, None)]
    cases += [(510, 512, w, aligned, 0.37, wc) for wc in nbmm.F2_APPLY_WORDS
              for w, aligned in ((250, True), (256, False))]
    return cases


@pytest.mark.parametrize("k,e,w,aligned,share,wc", _apply_cases())
def test_f2_apply_kernel_matches_plain(cuda_device, k, e, w, aligned, share, wc):
    """The apply with a share of its rows placed (the rest discards at -1, n
    and beyond), two whole frames placing none, transform rows of ~96 set
    bits and bits past K set; against both plain versions."""
    rng = np.random.default_rng(k + w)
    b, n = 6, 4 * k
    kw = -(-k // 32)
    dev = cuda_device
    rhs = to_torch(random_words(rng, (b, k, w))).to(dev)
    bits = rng.random((b, e, 32 * kw)) < 96 / k
    bits[:, :, k:] = rng.random((b, e, 32 * kw - k)) < 0.5  # past K: ignored
    t = pack_bits(torch.from_numpy(bits)).to(dev)
    values = to_torch(random_words(rng, (b, n, w))).to(dev)
    if not aligned:
        rhs, values = _misaligned(rhs), _misaligned(values)
    idx = np.stack([rng.permutation(n)[:e] for _ in range(b)]).astype(np.int32)
    drop = rng.random((b, e)) >= share
    idx[drop] = rng.choice([-1, n, n + 100], int(drop.sum()))
    idx[-2:] = n  # frames with no placed row
    idx = torch.from_numpy(idx).to(dev)
    before = nbmm.f2_apply_scatter.launches
    if wc is None:
        assert nbmm.f2_apply_slab_words(k, e, n, w) is not None
        got = nbmm.f2_apply_scatter(values, rhs, t, idx)
    else:
        got = nbmm.launch_apply(values, rhs, t, idx, wc)
    torch.cuda.synchronize()
    assert nbmm.f2_apply_scatter.launches == before + 1
    want = nbmm.f2_apply_scatter_reference(values, rhs, t, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, nbmm.f2_apply_rows_reference(values, rhs, t, idx),
                               rtol=0, atol=0)


def _matmul_cases():
    """(k, e, w, aligned, real share, Wc (None: the wrapper's route; 0: the
    bit scan)): the GE bucket's shape with 37% and 1% of its rows real; W
    = 250 (not a multiple of the chunk), 5 and 3, misaligned; every Wc of
    the list route and the bit scan at the bucket; K = 6000, whose slab
    does not fit, on the wrapper's route (the bit scan)."""
    cases = [(510, 512, 256, True, 0.37, None), (510, 512, 256, True, 0.01, None),
             (510, 512, 250, True, 0.37, None), (510, 512, 256, False, 0.37, None),
             (510, 512, 5, True, 0.37, None), (510, 512, 3, False, 0.37, None),
             (40, 9, 5, True, 0.5, None), (6000, 40, 8, True, 0.5, None)]
    cases += [(510, 512, w, aligned, 0.37, wc) for wc in (*nbmm.F2_MATMUL_WORDS, 0)
              for w, aligned in ((250, True), (256, False))]
    return cases


@pytest.mark.parametrize("k,e,w,aligned,real,wc", _matmul_cases())
def test_f2_matmul_kernel_matches_plain(cuda_device, k, e, w, aligned, real, wc):
    """The transform rows with a share of its rows real (~96 set bits of
    K), the rest zero (an empty list), bits past K set: every route and Wc
    against both plain versions, one launch counted each."""
    rng = np.random.default_rng(k + w)
    b = 4
    kw = -(-k // 32)
    dev = cuda_device
    rhs = to_torch(random_words(rng, (b, k, w))).to(dev)
    bits = rng.random((b, e, 32 * kw)) < min(0.5, 96 / k)
    bits[rng.random((b, e)) >= real] = False
    bits[:, :, k:] = rng.random((b, e, 32 * kw - k)) < 0.5  # past K: ignored
    t = pack_bits(torch.from_numpy(bits)).to(dev)
    if not aligned:
        rhs = _misaligned(rhs)
    before = nbmm.f2_matmul_batched.launches
    if wc is None:
        route = nbmm.f2_matmul_route(k, w)
        assert route == ("scan" if k > 4000 else "list")
        got = nbmm.f2_matmul_batched(rhs, t)
    elif wc == 0:
        got = nbmm.launch_matmul_scan(rhs, t)
    else:
        got = nbmm.launch_matmul_rows(rhs, t, wc)
    torch.cuda.synchronize()
    assert nbmm.f2_matmul_batched.launches == before + 1
    want = nbmm.f2_matmul_batched_reference(rhs, t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, nbmm.f2_matmul_rows_reference(rhs, t), rtol=0, atol=0)


def test_f2_matmul_refuses_shapes_no_route_takes(cuda_device):
    """K past the bit scan's staging (and the list route's slab): the
    wrapper raises and launches nothing; a Wc outside the list route's
    widths raises too."""
    rhs = torch.zeros((1, 40000, 1), dtype=torch.int32, device=cuda_device)
    t = torch.zeros((1, 2, 1250), dtype=torch.int32, device=cuda_device)
    assert nbmm.f2_matmul_route(40000, 1) is None
    before = nbmm.f2_matmul_batched.launches
    with pytest.raises(ValueError, match="no route"):
        nbmm.f2_matmul_batched(rhs, t)
    with pytest.raises(ValueError, match="bit scan"):
        nbmm.launch_matmul_scan(rhs, t)
    small = torch.zeros((1, 64, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="Wc must be one of"):
        nbmm.launch_matmul_rows(small, torch.zeros((1, 2, 2), dtype=torch.int32,
                                                   device=cuda_device), 64)
    assert nbmm.f2_matmul_batched.launches == before


def _f2_rows_cases():
    """(name, w, aligned, Wc (None: the wrapper's choice)): each shipped H
    at the wrapper's Wc (W = 256, misaligned, 5, 3), then at each Wc that
    fits (from the code's sizes, no card needed), ragged or misaligned."""
    cases = [(name, w, aligned, None) for name in SHIPPED
             for w, aligned in ((256, True), (256, False), (5, True), (3, True))]
    for name in SHIPPED:
        code = get_code(name)
        d = int(code.vlist_len.max())
        cases += [(name, 250 if wc != 8 else 64, wc != 8, wc) for wc in nbmm.F2_SLAB_WORDS
                  if nbmm.f2_rows_smem(code.n, code.m, d, wc) <= peel.SMEM_LIMIT]
    return cases


@pytest.mark.parametrize("name,w,aligned,wc", _f2_rows_cases())
def test_f2_matvec_list_route_matches_plain(cuda_device, name, w, aligned, wc):
    """The list route on each shipped H (the route each takes), at every
    slab width that fits, ragged and misaligned; erased slots hold zero."""
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    idx, length = arrays.h_rows
    assert idx.shape[1] == int(code.vlist_len.max())
    assert nbmm.f2_slab_words(idx, code.n, w) is not None
    rng = np.random.default_rng(w)
    v = random_words(rng, (4, code.n, w))
    v[rng.random((4, code.n)) < 0.2] = 0
    values = to_torch(v).to(cuda_device)
    if not aligned:
        values = _misaligned(values)
    before = nbmm.f2_matvec_wide.launches
    if wc is None:
        got = nbmm.f2_matvec_wide(values, arrays.h_words, rows=arrays.h_rows)
    else:
        got = nbmm.launch_rows(values, idx, length, wc)
    torch.cuda.synchronize()
    assert nbmm.f2_matvec_wide.launches == before + 1
    torch.testing.assert_close(got, nbmm.f2_matvec_wide_reference(values, arrays.h_words),
                               rtol=0, atol=0)


@pytest.mark.parametrize("w", [256, 5])
def test_f2_matvec_list_route_edge_rows(cuda_device, w):
    """A row of weight 0, one at the list route's weight threshold (K // 8)
    and bits past K set in the packed matrix take the list route; one more
    bit in a row moves the matrix to the bit scan, with the same product."""
    rng = np.random.default_rng(11)
    k, m, b = 300, 12, 3
    top = k // nbmm.F2_LIST_SPARSITY
    bits = rng.random((m, 320)) < 0.03
    bits[0] = False
    bits[1] = False
    bits[1, rng.choice(k, top, replace=False)] = True
    bits[:, k:] = rng.random((m, 320 - k)) < 0.5  # past K: ignored
    h = pack_bits(torch.from_numpy(bits)).to(cuda_device)
    values = to_torch(random_words(rng, (b, k, w))).to(cuda_device)
    rows = nbmm.f2_matrix_rows(h, k)
    assert rows[0].shape[1] == top and int(rows[1][0]) == 0
    assert nbmm.f2_slab_words(rows[0], k, w) is not None
    want = nbmm.f2_matvec_wide_reference(values, h)
    got = nbmm.f2_matvec_wide(values, h, rows=rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bits[2, :k] = False
    bits[2, rng.choice(k, top + 1, replace=False)] = True
    h = pack_bits(torch.from_numpy(bits)).to(cuda_device)
    rows = nbmm.f2_matrix_rows(h, k)
    assert nbmm.f2_slab_words(rows[0], k, w) is None
    got = nbmm.f2_matvec_wide(values, h, rows=rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, nbmm.f2_matvec_wide_reference(values, h), rtol=0, atol=0)


def _peeled(code, arrays, b, w, per, peel_iters, seed):
    rng = np.random.default_rng(seed)
    src = to_torch(random_words(rng, (b, code.k, w))).to(arrays.device)
    cw = encode_packed(arrays, src)
    mask = torch.from_numpy(rng.random((b, code.n)) < per).to(arrays.device)
    return cw, mask


@pytest.mark.parametrize("return_rows", [False, True])
@pytest.mark.parametrize("static_topo", [False, True])
def test_ge_solve_packed_cuda_matches_cpu(cuda_device, return_rows, static_topo):
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, cuda_device)
    cw, mask = _peeled(code, arrays, 32, 8, 0.2031, 10, 11)
    v, e, _ = peel_decode(arrays, cw, mask, max_iters=10)
    assert e.any()
    got = ge_solve_packed(arrays, v, e, emax=512, return_rows=return_rows,
                          static_topo=static_topo)
    want = ge_solve_packed(code_arrays(code, "cpu"), v.cpu(), e.cpu(), emax=512,
                           return_rows=return_rows, static_topo=static_topo)
    torch.cuda.synchronize()
    ok = ~want[-1]
    for g, w in zip(got, want):
        g = g.cpu()
        torch.testing.assert_close(g[ok] if g.dim() == 3 else g, w[ok] if w.dim() == 3 else w,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("per,peel_iters", [(0.05, 10), (0.25, 2)], ids=["all_peeled", "all_residual"])
@pytest.mark.parametrize("tiled", [True, False])
def test_hybrid_cuda_matches_cpu(cuda_device, per, peel_iters, tiled):
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, cuda_device)
    cw, mask = _peeled(code, arrays, 16, 4, per, peel_iters, 12)
    kw = dict(peel_iters=peel_iters, emax=512, ge_subbatch=8, tiled=tiled, static_topo=True,
              return_overflow=True, impl="vmem")
    before = elim.f2_eliminate.launches
    got = hybrid_decode(arrays, cw, mask, **kw)
    torch.cuda.synchronize()
    want = hybrid_decode(code_arrays(code, "cpu"), cw.cpu(), mask.cpu(), **kw)
    resid = peel_decode(arrays, cw, mask, max_iters=peel_iters)[1].any(dim=1)
    assert bool(resid.all()) == (per == 0.25) and bool(resid.any()) == (per == 0.25)
    assert (elim.f2_eliminate.launches > before) == (per == 0.25)
    ok = ~want[3]
    torch.testing.assert_close(got[0].cpu()[ok], want[0][ok], rtol=0, atol=0)
    torch.testing.assert_close(got[0].cpu()[ok], cw.cpu()[ok], rtol=0, atol=0)
    _equal([x.cpu() for x in got[1:]], want[1:])


# GF(256): byte frames, four bytes to a word in the kernels.


def _misaligned_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous uint8 copy of ``t`` whose data pointer is 4 bytes past a
    16-byte boundary (still a whole word: the kernels' one-word path)."""
    flat = torch.empty(t.numel() + 4, dtype=torch.uint8, device=t.device)
    out = flat[4:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def _random_bytes(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("wb,aligned", [(1024, True), (1024, False), (12, True)])
def test_encode_nb_kernel_matches_plain(cuda_device, wb, aligned):
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, cuda_device)
    src = _random_bytes(np.random.default_rng(4), (8, code.k, wb), cuda_device)
    if not aligned:
        src = _misaligned_bytes(src)
    before = (encode_packed.launches, encode_packed.launches_gf256)
    got = encode_packed(arrays, src, gf_order=256)
    torch.cuda.synchronize()
    assert (encode_packed.launches, encode_packed.launches_gf256) == (before[0], before[1] + 1)
    assert got.dtype == torch.uint8
    torch.testing.assert_close(got, encode_packed_reference(arrays, src, gf_order=256),
                               rtol=0, atol=0)


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("wb,aligned,wc", [
    (1024, True, None), (1024, False, None), (20, True, None), (1024, True, 4),
    (1000, False, 16), (72, True, 12)])
def test_peel_nb_kernel_matches_plain(cuda_device, early_stop, wb, aligned, wc):
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(8)
    cw = encode_packed(arrays, _random_bytes(rng, (16, code.k, wb), cuda_device), gf_order=256)
    if not aligned:
        cw = _misaligned_bytes(cw)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.1406).to(cuda_device)
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None, gf_order=256)
    before = (peel_decode.launches, peel_decode.launches_gf256)
    if wc is None:
        got = peel_decode(arrays, cw, mask, **kw)
    else:
        k_stop = code.k if early_stop else code.n
        out, e, it = peel.launch_kernel(arrays, cw.view(torch.int32), mask, k_stop, 50, 256, wc)
        got = (out.view(torch.uint8), e, it)
    torch.cuda.synchronize()
    assert (peel_decode.launches, peel_decode.launches_gf256) == (before[0], before[1] + 1)
    _equal(got, peel_decode_reference(arrays, cw, mask, **kw))
    assert torch.equal(got[0][~got[1]], cw[~got[1]])


def _random_nb_cube(rng, b, m, c, emax, zero_pad_columns, edges=False):
    """Sparse random GF(256) byte systems: a third of the frames have zero
    rows past m - 4, two frames are all zero (they fail); with
    ``zero_pad_columns`` the A bytes past nreal are zero, as the solver
    makes them. ``edges``: frame 0 has nreal 0, and frame 1's A block is
    the identity (every pivot byte 1)."""
    by = rng.integers(0, 256, (b, m, 4 * c), dtype=np.uint8)
    by[rng.random((b, m, 4 * c)) < 0.6] = 0
    by[: b // 3, m - 4 :] = 0
    by[-2:] = 0
    nreal = rng.integers(0, emax + 1, b).astype(np.int32)
    if edges:
        nreal[0] = 0
        k = min(m, emax)
        by[1, :, :emax] = 0
        by[1, :k, :k] = np.eye(k, dtype=np.uint8)
        nreal[1] = k
    if zero_pad_columns:
        cols = np.arange(4 * c)
        pad = (cols[None, :] >= nreal[:, None]) & (cols[None, :] < emax)  # (B, 4C)
        by[np.broadcast_to(pad[:, None, :], by.shape)] = 0
    return torch.from_numpy(by.view(np.int32)), torch.from_numpy(nreal)


@pytest.mark.parametrize("a_words", [False, True], ids=["a_words_0", "a_words_wa"])
@pytest.mark.parametrize("b,m,c,emax,in_smem", [
    (64, 63, 32, 63, True), (64, 63, 32, 63, False), (8, 510, 160, 128, False),
    (3, 40, 3, 9, True), (3, 40, 3, 9, False),
    (40, 32, 16, 32, True), (40, 64, 32, 63, True), (40, 65, 32, 64, True),
    (16, 128, 32, 128, True), (16, 129, 40, 128, True), (8, 510, 224, 384, False),
])
def test_gf256_eliminate_kernel_matches_plain(cuda_device, a_words, b, m, c, emax, in_smem):
    """Both cube modes, with and without the a_words cuts, at the RS(255,192)
    cube (63 x 32 words, 8 KB) and the (2040,1530) escalation cubes (510 x
    160 and 224 words, which only the device-memory mode can hold); m = 32,
    64, 65, 128 and 129 on each side of a warp's 32 and 64 rows and of the
    128-thread block. The newer cases hold a frame with nreal 0 and one
    whose pivot bytes are 1."""
    rng = np.random.default_rng(m + c)
    cube, nreal = _random_nb_cube(rng, b, m, c, emax, zero_pad_columns=a_words,
                                  edges=b in (40, 16) or c == 224)
    cube, nreal = cube.to(cuda_device), nreal.to(cuda_device)
    aw = -(-emax // 4) if a_words else 0
    fits = elim.fits_shared_memory_gf256(m, c)
    assert fits == (m * c < 20000)
    before = elim.gf256_eliminate.launches
    got = elim.launch_kernel_gf256(cube, nreal, emax, aw, in_smem)
    torch.cuda.synchronize()
    assert elim.gf256_eliminate.launches == before + 1
    want = elim.gf256_eliminate_reference(cube, nreal, emax=emax, a_words=aw)
    _equal(got, want)
    if b >= 8:
        assert want[2].any() and not want[2].all()
    if not in_smem and fits:  # the wrapper picks shared memory here
        _equal(elim.gf256_eliminate(cube, nreal, emax=emax, a_words=aw), want)
    _equal(elim.gf256_eliminate_tables_reference(cube, nreal, emax=emax, a_words=aw), want)


@pytest.mark.parametrize("wb,aligned", [(1024, True), (1024, False), (12, True), (1000, True)])
@pytest.mark.parametrize("matrix", ["rs_dense", "rs_matrix_rows", "dense_edges", "ldpc_vlist",
                                    "random_sparse"])
def test_gf_matvec_kernel_matches_plain(cuda_device, wb, aligned, matrix):
    """The dense route: the RS H (255 x 63) as the code's Vlist and from
    ``matrix_rows``, and a dense matrix of coefficients 0, 1 and 0xFF with
    pad entries idx = n; the list route: the (2040,1530) GF(256) Vlist
    (2040 rows: read from device memory) and a sparse random matrix with
    zero and out-of-range list entries. W = 250 words is ragged."""
    from ldpc_erasure_codes_tpu_torch.rs import rs_code

    rng = np.random.default_rng(wb + len(matrix))
    tiles = None
    if matrix in ("random_sparse", "dense_edges"):
        n, m = (300, 40) if matrix == "random_sparse" else (200, 50)
        mat = rng.integers(0, 256, (n, m), dtype=np.uint8)
        if matrix == "random_sparse":
            mat[rng.random((n, m)) < 0.9] = 0
        else:
            mat = np.array([0, 1, 0xFF], dtype=np.uint8)[rng.integers(0, 3, (n, m))]
        idx, coef = nbmm.matrix_rows(torch.from_numpy(mat).to(cuda_device))
        idx[0, -1] = -1
        if matrix == "dense_edges":
            idx = torch.cat([idx, torch.full((m, 2), n, dtype=torch.int32, device=cuda_device)],
                            dim=1).contiguous()
            coef = torch.cat([coef, torch.full((m, 2), 0xFF, dtype=torch.uint8,
                                               device=cuda_device)], dim=1).contiguous()
    else:
        arrays = code_arrays(rs_code(255, 192) if matrix.startswith("rs")
                             else get_code("n2040_k1530_gf256"), cuda_device)
        n, idx, coef = arrays.n, arrays.vlist_idx, arrays.vlist_val
        if matrix == "rs_matrix_rows":
            idx, coef = nbmm.matrix_rows(arrays.h_nb.t().contiguous())
        else:
            tiles = arrays.vlist_tiles
    dense = matrix not in ("ldpc_vlist", "random_sparse")
    assert (nbmm.matrix_tiles(idx, coef, n) is not None) == dense
    values = _random_bytes(rng, (4, n, wb), cuda_device)
    if not aligned:
        values = _misaligned_bytes(values)
    before = nbmm.gf_matvec_wide.launches
    got = nbmm.gf_matvec_wide(values, idx, coef, tiles=tiles)
    torch.cuda.synchronize()
    assert nbmm.gf_matvec_wide.launches == before + 1
    torch.testing.assert_close(got, nbmm.gf_matvec_wide_reference(values, idx, coef),
                               rtol=0, atol=0)


@pytest.mark.parametrize("wb,aligned", [(1024, True), (1024, False), (12, True)])
@pytest.mark.parametrize("m,e,n", [(63, 63, 255), (510, 128, 2040), (9, 5, 40)])
def test_gf_apply_kernel_matches_plain(cuda_device, wb, aligned, m, e, n):
    """The RS transform (63 x 63) and the escalation's (128 x 510): rows of
    T . rhs placed at distinct targets, dump targets dropped."""
    rng = np.random.default_rng(m + wb)
    b = 4
    rhs = _random_bytes(rng, (b, m, wb), cuda_device)
    mats = _random_bytes(rng, (b, e, m), cuda_device)
    values = _random_bytes(rng, (b, n, wb), cuda_device)
    if not aligned:
        rhs, values = _misaligned_bytes(rhs), _misaligned_bytes(values)
    idx = np.stack([rng.permutation(n + 8)[:e] for _ in range(b)]).astype(np.int32)
    idx[0, :3] = [-1, n, n + 100]  # dropped targets
    idx = torch.from_numpy(idx).to(cuda_device)
    before = nbmm.gf_apply_scatter.launches
    got = nbmm.gf_apply_scatter(values, rhs, mats, idx)
    torch.cuda.synchronize()
    assert nbmm.gf_apply_scatter.launches == before + 1
    torch.testing.assert_close(got, nbmm.gf_apply_scatter_reference(values, rhs, mats, idx),
                               rtol=0, atol=0)


def _gf_apply_cases():
    """(m, e, n, wb, aligned, R (None: the wrapper's)): R = 16 (E = 10) and
    32 (E = 63: two tiles; 384: twelve), W = 250 words (not a multiple of
    the 64-word chunk), 3 words, misaligned; each R at the RS shape."""
    cases = [(9, 10, 40, 1024, True, None), (63, 63, 255, 1024, True, None),
             (63, 63, 255, 1000, True, None), (63, 63, 255, 1024, False, None),
             (63, 63, 255, 12, True, None), (510, 384, 2040, 256, True, None),
             (510, 384, 2040, 12, False, None)]
    cases += [(63, 63, 255, wb, aligned, r) for r in nbmm.GF_APPLY_ROWS
              for wb, aligned in ((1000, True), (1024, False))]
    return cases


@pytest.mark.parametrize("m,e,n,wb,aligned,r", _gf_apply_cases())
def test_gf_apply_tiled_kernel_matches_plain(cuda_device, m, e, n, wb, aligned, r):
    """The apply's tiles with ~60% of the rows placed (the rest dropped at
    -1, n and beyond), one frame placing none, and values in every slot
    (the slots that are not targets hold nonzero bytes, which the fused
    copy must carry over unchanged): against both plain versions, one
    launch counted; the copy cut leaves the placed rows as they were."""
    rng = np.random.default_rng(m + e + wb)
    b = 5
    dev = cuda_device
    rhs = _random_bytes(rng, (b, m, wb), dev)
    mats = _random_bytes(rng, (b, e, m), dev)
    values = _random_bytes(rng, (b, n, wb), dev)
    if not aligned:
        rhs, values = _misaligned_bytes(rhs), _misaligned_bytes(values)
    idx = np.stack([rng.permutation(n)[:e] for _ in range(b)]).astype(np.int32)
    drop = rng.random((b, e)) >= 0.6
    idx[drop] = rng.choice([-1, n, n + 100], int(drop.sum()))
    idx[-1] = n  # a frame that places no row
    idx = torch.from_numpy(idx).to(dev)
    before = nbmm.gf_apply_scatter.launches
    rr = nbmm.gf_apply_rows(e) if r is None else r
    got = (nbmm.gf_apply_scatter(values, rhs, mats, idx) if r is None
           else nbmm.launch_gf_apply(values, rhs, mats, idx, r))
    torch.cuda.synchronize()
    assert nbmm.gf_apply_scatter.launches == before + 1
    want = nbmm.gf_apply_scatter_reference(values, rhs, mats, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, nbmm.gf_apply_tiles_reference(values, rhs, mats, idx),
                               rtol=0, atol=0)
    assert torch.equal(got[-1], values[-1])
    rows = nbmm.launch_gf_apply(values, rhs, mats, idx, rr, copy=False)
    keep = (idx >= 0) & (idx < n)
    frames = torch.arange(b, device=dev)[:, None].expand_as(idx)[keep]
    assert torch.equal(rows[frames, idx[keep].long()], want[frames, idx[keep].long()])


def test_gf_apply_refuses_blocks_over_shared_memory(cuda_device):
    """E whose targets do not fit a block's shared memory, or an R outside
    the tile sizes: the wrapper raises and launches nothing."""
    b, m, e, n = 1, 2, 60000, 255
    values = torch.zeros((b, n, 4), dtype=torch.uint8, device=cuda_device)
    rhs = torch.zeros((b, m, 4), dtype=torch.uint8, device=cuda_device)
    mats = torch.zeros((b, e, m), dtype=torch.uint8, device=cuda_device)
    idx = torch.full((b, e), n, dtype=torch.int32, device=cuda_device)
    before = nbmm.gf_apply_scatter.launches
    with pytest.raises(ValueError, match="shared memory"):
        nbmm.gf_apply_scatter(values, rhs, mats, idx)
    with pytest.raises(ValueError, match="R must be one of"):
        nbmm.launch_gf_apply(values, rhs, mats[:, :8].contiguous(), idx[:, :8].contiguous(), 64)
    assert nbmm.gf_apply_scatter.launches == before


def test_rs_decode_wide_cuda_matches_cpu(cuda_device):
    """RS(255,192) with 1 .. 64 erasures: the three kernels' path equals the
    plain path and the MDS contract."""
    from ldpc_erasure_codes_tpu_torch.rs import rs_code, rs_decode_wide, rs_encode
    from ldpc_erasure_codes_tpu_torch.utils.verify import check_rs

    code = rs_code(255, 192)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(3)
    b = 16
    cw = rs_encode(arrays, _random_bytes(rng, (b, code.k, 64), cuda_device))
    mask = np.zeros((b, code.n), bool)
    for f, e in enumerate(np.linspace(1, 64, b).astype(int)):
        mask[f, rng.choice(code.n, e, replace=False)] = True
    mask = torch.from_numpy(mask).to(cuda_device)
    recv = cw.masked_fill(mask[:, :, None], 0)
    counts = [elim.gf256_eliminate.launches, nbmm.gf_matvec_wide.launches,
              nbmm.gf_apply_scatter.launches]
    got = rs_decode_wide(arrays, recv, mask)
    torch.cuda.synchronize()
    assert [elim.gf256_eliminate.launches, nbmm.gf_matvec_wide.launches,
            nbmm.gf_apply_scatter.launches] == [c + 1 for c in counts]
    report = check_rs(cw, mask, *got, n_minus_k=code.n - code.k)
    assert report["ok"] and report["failed_frames"] == 1, report
    want = rs_decode_wide(code_arrays(code, "cpu"), recv.cpu(), mask.cpu())
    ok = ~want[2]
    torch.testing.assert_close(got[0].cpu()[ok], want[0][ok], rtol=0, atol=0)
    _equal([x.cpu() for x in got[1:]], want[1:])


@pytest.mark.parametrize("escalated", [False, True])
def test_hybrid_nb_cuda_matches_cpu(cuda_device, escalated):
    """The GF(256) hybrid: the compacted byte GE (production) and, with
    buckets too small, the escalation through ge_solve_wide_nb with its
    cube in device memory."""
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(21)
    cw = encode_packed(arrays, _random_bytes(rng, (16, code.k, 16), cuda_device), gf_order=256)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.2031).to(cuda_device)
    kw = dict(gf_order=256, peel_iters=10, emax=128, ge_subbatch=4, impl="vmem")
    cpu = code_arrays(code, "cpu")
    if escalated:
        before = elim.gf256_eliminate.launches
        got = hybrid_decode_escalated(arrays, cw, mask, **kw)
        want = hybrid_decode_escalated(cpu, cw.cpu(), mask.cpu(), **kw)
        assert got[4] == want[4] > 0 and elim.gf256_eliminate.launches == before + 1
    else:
        got = hybrid_decode(arrays, cw, mask, tiled=True, **kw)
        want = hybrid_decode(cpu, cw.cpu(), mask.cpu(), tiled=True, **kw)
    torch.cuda.synchronize()
    ok = ~want[3]
    assert ok.any()
    torch.testing.assert_close(got[0].cpu()[ok], want[0][ok], rtol=0, atol=0)
    torch.testing.assert_close(got[0].cpu()[ok], cw.cpu()[ok], rtol=0, atol=0)
    _equal([x.cpu() for x in got[1:4]], want[1:4])


# The research schedules, visit orders of csrc/peel.cu's schedule kernel
# before its slab value kernel. "counted" and "grouped" are the sequential
# function (peel_decode_reference's); "jacobi" is
# peel_decode_jacobi_reference's. W=200 is ragged (not a multiple of the
# slab width), W=5 takes the one-word path; n4000_k2000 sizes the shared
# memory of both csrc/peel.cu kernels.
def _sched_plain(schedule):
    return peel_decode_jacobi_reference if schedule == "jacobi" else peel_decode_reference


@pytest.mark.parametrize("schedule", ["counted", "grouped", "jacobi"])
@pytest.mark.parametrize("name", ["n2040_k1530", "n4000_k2000"])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (200, True), (5, True)])
def test_research_schedule_kernel_matches_plain(cuda_device, schedule, name, early_stop, w,
                                                aligned):
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(17)
    cw = encode_packed(arrays, to_torch(random_words(rng, (16, code.k, w))).to(cuda_device))
    if not aligned:
        cw = _misaligned(cw)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.1406).to(cuda_device)
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None)
    counter = f"launches_{schedule}"
    before = getattr(peel_decode, counter)
    got = peel_decode(arrays, cw, mask, schedule=schedule, **kw)
    torch.cuda.synchronize()
    assert getattr(peel_decode, counter) == before + 1
    _equal(got, _sched_plain(schedule)(arrays, cw, mask, **kw))
    assert torch.equal(got[0][~got[1]], cw[~got[1]]) and not got[0][got[1]].any()
    if schedule != "jacobi":
        _equal(got, peel_decode(arrays, cw, mask, **kw))
    else:
        v, e, it = peel_decode_jacobi(arrays, cw, mask, **kw)
        _equal((got[1][:, : code.k], got[2]), (e[:, : code.k], it))


@pytest.mark.parametrize("schedule", ["counted", "grouped", "jacobi"])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("wb,aligned", [(1024, True), (1024, False), (20, True)])
def test_peel_schedule_nb_kernel_matches_plain(cuda_device, schedule, early_stop, wb, aligned):
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(18)
    cw = encode_packed(arrays, _random_bytes(rng, (16, code.k, wb), cuda_device), gf_order=256)
    if not aligned:
        cw = _misaligned_bytes(cw)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.1406).to(cuda_device)
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None, gf_order=256)
    counter = f"launches_{schedule}_gf256"
    before = getattr(peel_decode, counter)
    got = peel_decode(arrays, cw, mask, schedule=schedule, **kw)
    torch.cuda.synchronize()
    assert getattr(peel_decode, counter) == before + 1
    _equal(got, _sched_plain(schedule)(arrays, cw, mask, **kw))
    assert torch.equal(got[0][~got[1]], cw[~got[1]])


def _peeled_residuals(arrays, b, per, seed, dev):
    """Pattern-only residuals of i.i.d. masks peeled to convergence."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((b, arrays.n)) < per).to(dev)
    return peel_decode_mask(arrays, mask, max_iters=200)[0]


# The rank kernel's routes, by shape: "registers" where m <= 1024 and emax
# <= 512, "smem" where the matrix fits in shared memory, "device" always;
# the wrapper takes the first that fits. (4000,2000) takes "smem" at emax
# 128 and 256 (2000 rows) and only "device" at emax 1024; (2000,1000) takes
# "smem" at emax 1024 (33 words a row).
RANK_FITS = {
    ("n2040_k1530", 256): ("registers", "smem", "device"),
    ("n2040_k1530", 512): ("registers", "smem", "device"),
    ("n2000_k1000", 512): ("registers", "smem", "device"),
    ("n2000_k1000", 1024): ("smem", "device"),
    ("n4000_k2000", 128): ("smem", "device"),
    ("n4000_k2000", 256): ("smem", "device"),
    ("n4000_k2000", 1024): ("device",),
}


@pytest.mark.parametrize("route", rank.ROUTES)
@pytest.mark.parametrize("name,b,per,emax", [
    ("n2040_k1530", 64, 0.1875, 256),
    ("n2040_k1530", 64, 0.2031, 512),
    ("n4000_k2000", 8, 0.44, 1024),
    ("n2000_k1000", 16, 0.42, 512),
    ("n2000_k1000", 16, 0.44, 1024),
])
def test_rank_kernel_matches_plain(cuda_device, name, b, per, emax, route):
    """Each route on peeled residuals, where it fits; where it does not
    (``RANK_FITS``) the wrapper raises. ``f2_rank_check`` and
    ``ge_rank_check`` take the first route that fits."""
    arrays = code_arrays(get_code(name), cuda_device)
    e = _peeled_residuals(arrays, b, per, 5, cuda_device)
    assert e.any()
    fits = route in RANK_FITS[name, emax]
    assert rank.route_fits(route, arrays.n, arrays.m, emax) == fits
    assert rank.kernel_route(arrays.n, arrays.m, emax) == RANK_FITS[name, emax][0]
    if not fits:
        with pytest.raises(ValueError):
            rank.launch_kernel(arrays, e, emax, route)
        return
    want = rank.f2_rank_check_reference(arrays, e, emax=emax)
    torch.testing.assert_close(want, ge_rank_check_reference(arrays, e, emax=emax), rtol=0,
                               atol=0)
    before = rank.f2_rank_check.launches
    got = rank.launch_kernel(arrays, e, emax, route)
    via_ge = ge_rank_check(arrays, e, emax=emax)
    torch.cuda.synchronize()
    assert rank.f2_rank_check.launches == before + 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(via_ge, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", rank.ROUTES)
@pytest.mark.parametrize("emax,per", [(128, 0.03), (256, 0.06)])
def test_rank_kernel_on_unpeeled_masks(cuda_device, emax, per, route):
    """(4000,2000) at emax 128 (the CLI's default) and 256, on i.i.d. masks
    as the ML decoder checks them: about 120 and 240 erasures a frame, some
    past emax. Peeled residuals of this code are empty or far past emax, so
    they would leave the elimination idle."""
    arrays = code_arrays(get_code("n4000_k2000"), cuda_device)
    rng = np.random.default_rng(emax)
    e = torch.from_numpy(rng.random((64, arrays.n)) < per).to(cuda_device)
    nreal = e.sum(dim=1)
    assert bool((nreal <= emax).any()) and bool((nreal > emax).any())
    fits = route in RANK_FITS["n4000_k2000", emax]
    assert rank.route_fits(route, arrays.n, arrays.m, emax) == fits
    if not fits:
        with pytest.raises(ValueError):
            rank.launch_kernel(arrays, e, emax, route)
        return
    want = rank.f2_rank_check_reference(arrays, e, emax=emax)
    torch.testing.assert_close(want, ge_rank_check_reference(arrays, e, emax=emax), rtol=0,
                               atol=0)
    got = rank.launch_kernel(arrays, e, emax, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", rank.ROUTES)
def test_rank_kernel_on_dependent_columns(cuda_device, route):
    """Supports of single-source-bit codewords (their columns sum to zero:
    rank deficient) and the same with one symbol kept (independent), by
    each route."""
    code = get_code("n2040_k1530")
    cpu = code_arrays(code, "cpu")
    cw = encode(cpu, torch.eye(code.k, dtype=torch.uint8)[:64]).bool()
    kept = cw.clone()
    kept[torch.arange(64), cw.to(torch.uint8).argmax(dim=1)] = False
    e = torch.cat([cw, kept]).to(cuda_device)
    arrays = code_arrays(code, cuda_device)
    want = rank.f2_rank_check_reference(arrays, e, emax=256)
    got = rank.launch_kernel(arrays, e, 256, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert want[:64].all() and not want[64:].all()


@pytest.mark.parametrize("name,emax,route", [
    *[(name, emax, route) for (name, emax), routes in RANK_FITS.items() if name != "n2000_k1000"
      for route in routes],
    ("n2000_k1000", 512, "registers"), ("n2000_k1000", 1024, "smem"),
])
def test_rank_kernel_edge_cases(cuda_device, name, emax, route):
    """``rank_edge_masks``: no erasure, 31/32/33 erasures, emax and emax +
    1, and codeword supports whose last column (65, 96 or emax columns in:
    a word's first column, a word's last, the last panel's last) is the
    dependent one, with and without it; each route against both plain
    versions."""
    code = get_code(name)
    cpu = code_arrays(code, "cpu")
    mask, dependent = rank_edge_masks(cpu, code.k, emax, 13)
    arrays = code_arrays(code, cuda_device)
    e = mask.to(cuda_device)
    want = rank.f2_rank_check_reference(arrays, e, emax=emax)
    torch.testing.assert_close(want, ge_rank_check_reference(arrays, e, emax=emax), rtol=0,
                               atol=0)
    got = rank.launch_kernel(arrays, e, emax, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not want[0] and want[5] and want[dependent.to(cuda_device)].all()


@pytest.mark.parametrize("dtype,w,aligned", [
    (torch.int32, 256, True), (torch.int32, 256, False), (torch.int32, 3, True),
    (torch.uint8, 1024, True),
])
@pytest.mark.parametrize("num", [0, 9, 64])
def test_channel_kernel_matches_plain(cuda_device, dtype, w, aligned, num):
    rng = np.random.default_rng(w + num)
    if dtype == torch.uint8:
        values = _random_bytes(rng, (64, 2040, w), cuda_device)
    else:
        values = to_torch(random_words(rng, (64, 2040, w))).to(cuda_device)
        if not aligned:
            values = _misaligned(values)
    before = channel.channel_apply_per64.launches
    got = channel.channel_apply_per64(values, 2024, num)
    torch.cuda.synchronize()
    assert channel.channel_apply_per64.launches == before + 1
    _equal(got, channel.channel_apply_per64_reference(values, 2024, num))
    cpu = channel.channel_apply_per64(values.cpu(), 2024, num)
    torch.testing.assert_close(got[1].cpu(), cpu[1], rtol=0, atol=0)


# (B, m, E): the padded and unpadded RS shapes, a small one, every E in
# (1, 16, 17, 32, 33, 64) (R = 16 or 32, one tile or more, a last tile
# short) against m in (1, 31, 33, 255) (one panel of columns or more, a
# last panel short), and the RS batch (B = 1024, m = E = 63).
MATMUL_SHAPES = ([(8, 63, 63), (8, 64, 56), (8, 9, 5)]
                 + [(8, m, e) for e in (1, 16, 17, 32, 33, 64) for m in (1, 31, 33, 255)]
                 + [(1024, 63, 63)])


@pytest.mark.parametrize("wb,aligned", [(1024, True), (1024, False), (12, True)])
@pytest.mark.parametrize("b,m,e", MATMUL_SHAPES)
def test_gf_matmul_kernel_matches_plain(cuda_device, wb, aligned, b, m, e):
    """The in-order tiled product against both plain versions (the column
    loop and the tiles twin), one launch a call, at every shape above with
    W = 1024 bytes (16 word chunks), misaligned, and 12 bytes (a chunk
    mostly idle)."""
    rng = np.random.default_rng(m + e + wb + b)
    rhs = _random_bytes(rng, (b, m, wb), cuda_device)
    if not aligned:
        rhs = _misaligned_bytes(rhs)
    mats = _random_bytes(rng, (b, e, m), cuda_device)
    before = nbmm.gf_matmul_batched.launches
    got = nbmm.gf_matmul_batched(rhs, mats)
    torch.cuda.synchronize()
    assert nbmm.gf_matmul_batched.launches == before + 1
    torch.testing.assert_close(got, nbmm.gf_matmul_batched_reference(rhs, mats), rtol=0, atol=0)
    torch.testing.assert_close(got, nbmm.gf_matmul_tiles_reference(rhs, mats), rtol=0, atol=0)


def test_battery_quick_on_the_card(cuda_device):
    """The quick battery at JAX's chip widths (w 128, wb 512): every tier
    PASSED, through the kernels (the peel's launches rise)."""
    before = peel_decode.launches
    records = verify.run_battery(device=cuda_device, quick=True)
    assert [r["tier"] for r in records] == list(verify.TIERS)
    for r in records:
        assert r["status"] == "PASSED", r
    assert peel_decode.launches > before


@pytest.mark.parametrize("kind", ["binary", "nb", "rs"])
def test_golden_on_the_card(cuda_device, tmp_path, kind):
    """Golden sets the port's oracle side writes, verified by the port's
    encoders and decoders on the card, 8 words (32 bytes) per symbol."""
    if kind == "binary":
        code = get_code("n2000_k1000")
        golden.generate_golden(code, tmp_path, frames=2, per=0.25, seed=1)
        passed, report = golden.verify_golden(code, tmp_path, device=cuda_device)
    elif kind == "nb":
        code = get_code("n2040_k1530_gf256")
        golden.generate_golden_nb(code, tmp_path, frames=2, seed=1)
        passed, report = golden.verify_golden_nb(code, tmp_path, device=cuda_device)
    else:
        golden.generate_golden_rs(255, 192, tmp_path, frames=2, seed=1)
        passed, report = golden.verify_golden_rs(255, 192, tmp_path, device=cuda_device)
    assert passed, report
    assert report.endswith("frames=2 encode=PASSED decode=PASSED")
