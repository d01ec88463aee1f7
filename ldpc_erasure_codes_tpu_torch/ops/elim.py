"""Swap-free Gauss-Jordan elimination of packed [A | T] cubes, over GF(2)
(bits) and GF(256) (bytes).

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_elim.py::
f2_eliminate`` (:252-412), the elimination inside ``ops/ge.py::
ge_solve_packed`` (step :266-283). The TPU kernel keeps the batch on its
128 lanes, (C, m_pad, B); the port keeps one frame's rows together,
(B, m, C), because on Hopper a frame's cube is one block's shared memory.
:func:`f2_eliminate` launches ``csrc/elim.cu`` for CUDA tensors and runs
:func:`f2_eliminate_reference` for CPU tensors. The kernel computes the
same function 32 columns (one word) at a time, skipping words that are
zero in every row of a frame; :func:`f2_eliminate_panels_reference` is
that order in plain PyTorch.

With ``a_words`` > 0 both apply the TPU kernel's two exact cuts: the
column loop stops at the batch's widest residual ``min(max(nreal), emax)``,
and A words left of the current column are not updated. Pivot rows and
failure flags are unchanged by the cuts; the cubes of failed frames may
differ from the uncut elimination (pallas_elim.py:272-287). The kernel and
the plain version apply the same cuts, so they agree on every output.

:func:`gf256_eliminate` is the counterpart of the TPU kernel
``pallas_elim.py::gf256_eliminate`` (:75-246), the elimination of
``ops/ge.py::ge_solve_wide_nb``: the same layout and cuts with byte
columns (byte ``col & 3`` of word ``col >> 2``), the pivot row normalised
by the field inverse and written back, and every other row with a nonzero
byte ``f`` in the column updated by ``row ^= f * pivot_row``. The kernel
computes each product from a table of the pivot row's nibble products,
with the normalisation folded into the factors;
:func:`gf256_eliminate_tables_reference` is that form in plain PyTorch.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import gf_mul_packed, table
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.nbmm import _nibble_products


def _check(cube: torch.Tensor, nreal: torch.Tensor, emax: int, a_words: int) -> None:
    if cube.dtype != torch.int32 or nreal.dtype != torch.int32:
        raise TypeError(f"cube and nreal must be torch.int32, got {cube.dtype}, {nreal.dtype}")
    if cube.dim() != 3:
        raise ValueError(f"cube must be (B, m, C), got {tuple(cube.shape)}")
    b, _, c = cube.shape
    if nreal.shape != (b,):
        raise ValueError(f"nreal shape {tuple(nreal.shape)} != ({b},)")
    if not 0 <= emax <= 32 * c:
        raise ValueError(f"emax={emax} outside 0..{32 * c} (the cube's bit columns)")
    if not 0 <= a_words <= c:
        raise ValueError(f"a_words={a_words} outside 0..{c}")
    if cube.device != nreal.device:
        raise ValueError(f"cube on {cube.device}, nreal on {nreal.device}")
    if not (cube.is_contiguous() and nreal.is_contiguous()):
        raise ValueError("cube and nreal must be contiguous")


def f2_eliminate_reference(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch elimination: a Python loop over pivot columns of
    whole-cube tensor operations, as ge.py's ``step`` (:266-283)."""
    _check(cube, nreal, emax, a_words)
    b, m, _ = cube.shape
    dev = cube.device
    r = cube.clone()
    used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    pivrow = torch.zeros((b, emax), dtype=torch.int32, device=dev)
    failed = torch.zeros((b,), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    frames = torch.arange(b, device=dev)
    ub = emax
    if a_words:
        ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        colv = ((r[:, :, col >> 5] >> (col & 31)) & 1).bool()  # (B, m)
        cand = colv & ~used
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), 0)  # first row
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        used |= is_piv
        pivrow[:, col] = piv.to(torch.int32)
        c0 = min(col >> 5, a_words) if a_words else 0
        prow = r[frames, piv, c0:]  # (B, C - c0)
        elim = colv & ~is_piv & has[:, None]
        r[:, :, c0:] ^= torch.where(elim[:, :, None], prow[:, None, :], 0)
        failed |= ~has & (col < nreal)
    return r, pivrow, failed


def f2_eliminate_panels_reference(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch elimination in the kernel's order (``csrc/elim.cu``):
    32 columns (one word j) at a time. Equal to
    :func:`f2_eliminate_reference` on every output.

    Per panel j and frame: (1) a panel whose word j is zero in every row
    finds no pivot and changes nothing; it only sets ``failed`` where
    32j < nreal. (2) Otherwise the column steps run on word j alone, and
    each row r keeps a combination word S_r of the panel's pivots whose
    starting rows it has absorbed: row r taking pivot i (row p_i) sets
    S_r ^= S_{p_i} | (1 << i). (3) The pivot rows as they were before the
    panel are staged, and every row takes row ^= XOR over i in S_r of
    staged row i on words [c0, C) (c0 = min(j, a_words) with the cuts, 0
    without): the words the column order updates for each column of the
    panel, so the cuts stay exact.

    ``stats``, where given, receives the work in this order: ``panels``
    (frames x panels), ``live_panels`` (those not skipped), and
    ``column_steps`` (the column steps of the live panels), against the
    column order's ``B x ub`` column steps."""
    _check(cube, nreal, emax, a_words)
    b, m, c = cube.shape
    dev = cube.device
    r = cube.clone()
    used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    pivrow = torch.zeros((b, emax), dtype=torch.int32, device=dev)
    failed = torch.zeros((b,), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    ub = emax
    if a_words:
        ub = min(int(nreal.max()), emax) if b else 0
    count = {"panels": b * -(-ub // 32), "live_panels": 0, "column_steps": 0}
    for j in range(-(-ub // 32)):
        ncol = min(32, ub - 32 * j)
        live = (r[:, :, j] != 0).any(dim=1)  # (1) the zero-panel skip
        failed |= ~live & (32 * j < nreal)
        act = live.nonzero()[:, 0]
        count["live_panels"] += len(act)
        count["column_steps"] += len(act) * ncol
        if not len(act):
            continue
        frames = torch.arange(len(act), device=dev)
        pw = r[act, :, j].long() & 0xFFFFFFFF  # (A, m) the panel words
        s = torch.zeros_like(pw)  # combination words
        u = used[act]
        piv = torch.zeros((len(act), 32), dtype=torch.long, device=dev)
        has = torch.zeros((len(act), 32), dtype=torch.bool, device=dev)
        for i in range(ncol):  # (2) the column steps on word j alone
            colv = ((pw >> i) & 1).bool()
            cand = colv & ~u
            has[:, i] = cand.any(dim=1)
            piv[:, i] = torch.where(has[:, i], cand.to(torch.uint8).argmax(dim=1), 0)
            is_piv = (rows[None, :] == piv[:, i, None]) & has[:, i, None]
            u |= is_piv
            pivrow[act, 32 * j + i] = piv[:, i].to(torch.int32)
            failed[act] |= ~has[:, i] & (32 * j + i < nreal[act])
            take = colv & ~is_piv & has[:, i, None]
            pw ^= torch.where(take, pw[frames, piv[:, i]][:, None], 0)
            s ^= torch.where(take, (s[frames, piv[:, i]] | (1 << i))[:, None], 0)
        used[act] = u
        c0 = min(j, a_words) if a_words else 0
        staged = r[act[:, None], piv, c0:]  # (3) (A, 32, C - c0), before the panel
        block = r[act, :, c0:]
        for i in range(ncol):
            block ^= torch.where(((s >> i) & 1).bool()[:, :, None], staged[:, i, None, :], 0)
        r[act, :, c0:] = block
    if stats is not None:
        stats.update(count)
    return r, pivrow, failed


# Rows a frame's cube may have on the kernel: warp 0 holds up to 64 per lane.
MAX_ROWS = 64 * 32


def launch_kernel(cube, nreal, emax: int, a_words: int, in_smem: bool):
    """Launch the kernel with the cube in shared memory (``in_smem``) or in
    device memory; :func:`f2_eliminate` picks the mode by size, the card
    tests force each."""
    b, m, c = cube.shape
    if m > MAX_ROWS:
        raise ValueError(f"a cube of {m} rows: the kernel takes at most {MAX_ROWS}")
    out = torch.empty_like(cube)
    pivrow = torch.empty((b, emax), dtype=torch.int32, device=cube.device)
    failed = torch.empty((b,), dtype=torch.int32, device=cube.device)
    # The loop bound stays on the device: no host sync.
    ncols = nreal.max().clamp(max=emax).reshape(1) if b else nreal.new_zeros(1)
    rc = _build.library().ldpc_elim_launch(
        cube.data_ptr(), out.data_ptr(), nreal.data_ptr(), ncols.data_ptr(),
        pivrow.data_ptr(), failed.data_ptr(), b, m, c, emax, a_words, int(in_smem),
        torch.cuda.current_stream(cube.device).cuda_stream,
    )
    _build.check(rc, "ldpc_elim_launch")
    f2_eliminate.launches += 1
    return out, pivrow, failed != 0


def fits_shared_memory(m: int, c: int) -> bool:
    """Whether a frame's (m, c)-word cube fits in one block's shared memory
    on the current CUDA device (the kernel's fast mode)."""
    return bool(_build.library().ldpc_elim_fits_smem(m, c))


def f2_eliminate(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GF(2) swap-free elimination of a packed-bit cube.

    Args:
      cube: (B, m, C) int32, the packed [A | T] rows of each frame; bit
        ``col`` of a row is bit ``col & 31`` of word ``col >> 5``.
      nreal: (B,) int32, the real erased columns of each frame: a column
        ``>= nreal`` that finds no pivot is not a failure.
      emax: the pivot columns to eliminate (bit columns 0..emax-1).
      a_words: leading words of each row that hold A; > 0 turns on the
        exact work cuts (module docstring).

    Returns:
      (cube_out (B, m, C) int32, pivrow (B, emax) int32 with the pivot row
      of each column, 0 where none; failed (B,) bool).

    CPU tensors take :func:`f2_eliminate_reference`; CUDA tensors launch
    the kernel (or raise), with the cube in shared memory when it fits
    there and in device memory otherwise. ``f2_eliminate.launches`` counts
    kernel launches.
    """
    _check(cube, nreal, emax, a_words)
    if cube.device.type == "cpu":
        return f2_eliminate_reference(cube, nreal, emax=emax, a_words=a_words)
    if cube.device.type != "cuda":
        raise ValueError(f"unsupported device {cube.device}")
    with torch.cuda.device(cube.device):
        in_smem = fits_shared_memory(cube.shape[1], cube.shape[2])
        return launch_kernel(cube, nreal, emax, a_words, in_smem)


f2_eliminate.launches = 0


def gf256_eliminate_reference(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch GF(256) elimination: a Python loop over pivot columns
    of whole-cube tensor operations, as ge.py's ``step`` (:582-612) with
    the Pallas kernel's cuts (pallas_elim.py:188-204)."""
    _check_nb(cube, nreal, emax, a_words)
    b, m, _ = cube.shape
    dev = cube.device
    inv = table("inv", dev)
    r = cube.clone()
    used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    pivrow = torch.zeros((b, emax), dtype=torch.int32, device=dev)
    failed = torch.zeros((b,), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    frames = torch.arange(b, device=dev)
    ub = emax
    if a_words:
        ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        colv = (r[:, :, col >> 2] >> (8 * (col & 3))) & 0xFF  # (B, m)
        cand = (colv != 0) & ~used
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), 0)  # first row
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        used |= is_piv
        pivrow[:, col] = piv.to(torch.int32)
        c0 = min(col >> 2, a_words) if a_words else 0
        norm = gf_mul_packed(r[frames, piv, c0:], inv[colv[frames, piv].long()][:, None])  # (B, C-c0)
        factor = torch.where(is_piv | ~has[:, None], 0, colv)  # (B, m)
        upd = r[:, :, c0:] ^ gf_mul_packed(norm[:, None, :], factor[:, :, None])
        r[:, :, c0:] = torch.where(is_piv[:, :, None], norm[:, None, :], upd)
        failed |= ~has & (col < nreal)
    return r, pivrow, failed


def gf256_eliminate_tables_reference(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch GF(256) elimination in the kernel's form
    (``csrc/elim.cu``): per column, the nibble products of the pivot row as
    it stands (:func:`.nbmm._nibble_products`, words [c0, C)), and the
    normalisation folded into the factors: the pivot row becomes its table
    at ``pinv`` (the inverse of its pivot byte), every other row with byte
    f != 0 takes ``row ^= table[f * pinv]``, each product two table reads.
    Equal to :func:`gf256_eliminate_reference`."""
    _check_nb(cube, nreal, emax, a_words)
    b, m, c = cube.shape
    dev = cube.device
    inv, mul = table("inv", dev), table("mul", dev)
    r = cube.clone()
    used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    pivrow = torch.zeros((b, emax), dtype=torch.int32, device=dev)
    failed = torch.zeros((b,), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    frames = torch.arange(b, device=dev)
    ub = emax
    if a_words:
        ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        colv = ((r[:, :, col >> 2] >> (8 * (col & 3))) & 0xFF).long()  # (B, m)
        cand = (colv != 0) & ~used
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), 0)  # first row
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        used |= is_piv
        pivrow[:, col] = piv.to(torch.int32)
        c0 = min(col >> 2, a_words) if a_words else 0
        lo, hi = _nibble_products(r[frames, piv, c0:])  # (B, 16, C - c0)
        pinv = inv[colv[frames, piv]].long()  # (B,)
        folded = mul[colv, pinv[:, None]].long()  # f * pinv, 0 where f == 0
        folded = torch.where(is_piv, pinv[:, None], folded)
        folded = torch.where(has[:, None], folded, 0)  # (B, m)
        wid = c - c0
        prod = (torch.gather(lo, 1, (folded & 15)[:, :, None].expand(b, m, wid))
                ^ torch.gather(hi, 1, (folded >> 4)[:, :, None].expand(b, m, wid)))
        r[:, :, c0:] = torch.where(is_piv[:, :, None], prod, r[:, :, c0:] ^ prod)
        failed |= ~has & (col < nreal)
    return r, pivrow, failed


def _check_nb(cube, nreal, emax: int, a_words: int) -> None:
    _check(cube, nreal, 0, a_words)
    if not 0 <= emax <= 4 * cube.shape[2]:
        raise ValueError(f"emax={emax} outside 0..{4 * cube.shape[2]} (the cube's byte columns)")


def launch_kernel_gf256(cube, nreal, emax: int, a_words: int, in_smem: bool):
    """Launch the GF(256) kernel with the cube in shared memory
    (``in_smem``) or in device memory; :func:`gf256_eliminate` picks the
    mode by size, the card tests force each."""
    b, m, c = cube.shape
    out = torch.empty_like(cube)
    pivrow = torch.empty((b, emax), dtype=torch.int32, device=cube.device)
    failed = torch.empty((b,), dtype=torch.int32, device=cube.device)
    ncols = nreal.max().clamp(max=emax).reshape(1) if b else nreal.new_zeros(1)
    log, exp = table("log", cube.device), table("exp", cube.device)
    rc = _build.library().ldpc_gf256_elim_launch(
        cube.data_ptr(), out.data_ptr(), nreal.data_ptr(), ncols.data_ptr(),
        pivrow.data_ptr(), failed.data_ptr(), log.data_ptr(), exp.data_ptr(), b, m, c, emax,
        a_words, int(in_smem), torch.cuda.current_stream(cube.device).cuda_stream,
    )
    _build.check(rc, "ldpc_gf256_elim_launch")
    gf256_eliminate.launches += 1
    return out, pivrow, failed != 0


def fits_shared_memory_gf256(m: int, c: int) -> bool:
    """Whether a frame's (m, c)-word GF(256) cube fits in one block's
    shared memory on the current CUDA device."""
    return bool(_build.library().ldpc_gf256_elim_fits_smem(m, c))


def gf256_eliminate(
    cube: torch.Tensor, nreal: torch.Tensor, *, emax: int, a_words: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GF(256) swap-free elimination of a packed byte cube.

    Args:
      cube: (B, m, C) int32, the [A | T] rows of each frame, four bytes per
        word, LSB first: byte ``col`` of a row is byte ``col & 3`` of word
        ``col >> 2``.
      nreal: (B,) int32 real erased columns of each frame.
      emax: the pivot columns to eliminate (byte columns 0..emax-1).
      a_words: leading words of each row that hold A; > 0 turns on the
        exact work cuts (module docstring).

    Returns:
      (cube_out (B, m, C) int32, its pivot rows normalised; pivrow
      (B, emax) int32, 0 where a column has no pivot; failed (B,) bool).

    CPU tensors take :func:`gf256_eliminate_reference`; CUDA tensors launch
    the kernel (or raise), with the cube in shared memory when it fits
    there and in device memory otherwise. ``gf256_eliminate.launches``
    counts kernel launches.
    """
    _check_nb(cube, nreal, emax, a_words)
    if cube.device.type == "cpu":
        return gf256_eliminate_reference(cube, nreal, emax=emax, a_words=a_words)
    if cube.device.type != "cuda":
        raise ValueError(f"unsupported device {cube.device}")
    with torch.cuda.device(cube.device):
        in_smem = fits_shared_memory_gf256(cube.shape[1], cube.shape[2])
        return launch_kernel_gf256(cube, nreal, emax, a_words, in_smem)


gf256_eliminate.launches = 0
