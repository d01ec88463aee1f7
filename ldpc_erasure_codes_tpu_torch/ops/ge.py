"""Batched Gauss-Jordan over GF(2) and GF(256) for wide frames: the ML
erasure solver of the hybrid decoder and of Reed-Solomon.

Counterpart of ``ldpc_erasure_codes_tpu/ops/ge.py``: ``erased_indices``
(:49-60), ``ge_solve_packed`` (:162-443), ``ge_solve_wide_nb`` (:487-745),
``ge_solve`` (:748-870) and ``ge_rank_check`` (:77-141). The binary solver solves
``H_erased . x = H_known . y_known`` per frame
(Matlab/My_LDPC_HybridML_Erasure_Decoder.m:48-88) in three steps:

1. the packed coefficient cube ``[A | T]``: A holds the erased columns of H
   (``emax`` bit columns, pad slots zero), T the identity that tracks the
   row operations (m bit columns). XLA builds it with plain tensor code
   (ge.py:234-251), as :func:`erased_indices` and :func:`coefficient_cube`
   do here for CPU tensors; for CUDA tensors one kernel writes the same
   bits from the mask and the Vlist (:func:`.cube.f2_cube`,
   ``csrc/cube.cu``);
2. the swap-free elimination of the cube (:mod:`.elim`, ``csrc/elim.cu``),
   which records the pivot row of each column and the failed frames;
3. the wide values touched once: the syndrome ``rhs = H . y``
   (:mod:`.synd` through the code's topology, or :mod:`.nbmm`'s dense
   ``f2_matvec_wide``), then ``x = T[pivot rows] . rhs``
   (``f2_matmul_batched`` for the rows alone, or ``f2_apply_scatter``,
   which also places them).

:func:`ge_solve_wide_nb` is its GF(256) analog on uint8 byte frames: the
[A | T] cube holds bytes, four to a word, eliminated by
:func:`.elim.gf256_eliminate` (``csrc/elim.cu``); the syndrome is
:func:`.nbmm.gf_matvec_wide` over the Vlist and the solved rows are applied
and placed by :func:`.nbmm.gf_apply_scatter` (``csrc/gfmm.cu``), the
structure of the JAX function's Pallas branch (:615-640, :668-709).
:func:`ge_solve` is the byte Gauss-Jordan with physical row swaps that the
JAX package runs outside any Pallas kernel (the NB hybrid's compacted GE
and ``rs_decode``); here it is plain PyTorch. :func:`ge_rank_check`, the
FER simulation's rank test, runs its pivot loop on the pattern alone
(:func:`ge_rank_check_reference`), or for binary CUDA tensors the rank
kernel of :mod:`.rank`.

Pivot order, failure flags and solved values equal the JAX package's;
values of failed frames are garbage in both, and callers gate on
``failed``.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_inv, gf_mul, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, pack_bits
from ldpc_erasure_codes_tpu_torch.ops.cube import f2_cube
from ldpc_erasure_codes_tpu_torch.ops.elim import f2_eliminate, gf256_eliminate
from ldpc_erasure_codes_tpu_torch.ops.encode import from_scalar_words, scalar_words
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_scatter,
    f2_matmul_batched,
    f2_matvec_wide,
    gf_apply_scatter,
    gf_matvec_wide,
)
from ldpc_erasure_codes_tpu_torch.ops.rank import f2_rank_check
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo
from ldpc_erasure_codes_tpu_torch.utils import profiling


def erased_indices(
    erased: torch.Tensor, emax: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame erased symbol indices, ascending, padded to ``emax``
    (clamped to n).

    Returns (er_idx (B, emax) int32, real (B, emax) bool, nreal (B,) int32).
    A stable argsort of the inverted mask lists the erased positions first
    in ascending order (the reference's ``find`` pivot order); the mask is
    sorted as uint8, since a stable sort of bool is not to be relied on.
    """
    b, n = erased.shape
    emax = min(emax, n)
    order = torch.argsort((~erased).to(torch.uint8), dim=1, stable=True)
    er_idx = order[:, :emax].to(torch.int32)
    nreal = erased.sum(dim=1, dtype=torch.int32)
    real = torch.arange(emax, device=erased.device)[None, :] < nreal[:, None]
    return er_idx, real, nreal


def coefficient_cube(
    arrays: CodeArrays, er_idx: torch.Tensor, real: torch.Tensor
) -> torch.Tensor:
    """The packed ``[A | T]`` rows of every frame, (B, m, wa + wt) int32:
    A = the erased columns of H (pad slots zero) in ``wa = ceil(emax/32)``
    words, T = the m x m identity in ``wt = ceil(m/32)`` words."""
    b = er_idx.shape[0]
    m = arrays.m
    a = arrays.h[:, er_idx.long()].permute(1, 0, 2) * real[:, None, :]  # (B, m, emax)
    a_pk = pack_bits(a)  # (B, m, wa)
    t_pk = pack_bits(torch.eye(m, dtype=torch.uint8, device=er_idx.device))  # (m, wt)
    return torch.cat([a_pk, t_pk.expand(b, *t_pk.shape)], dim=2).contiguous()


def pivot_transforms(r: torch.Tensor, pivrow: torch.Tensor, wa: int) -> torch.Tensor:
    """The T words of each column's pivot row (ge.py:328-331): (B, emax, wt)
    int32, row e of the transform that solves erased column e."""
    b, emax = pivrow.shape
    wt = r.shape[2] - wa
    index = pivrow.long()[:, :, None].expand(b, emax, wt)
    return r[:, :, wa:].gather(1, index).contiguous()


def _check(arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor) -> None:
    if values.dtype != torch.int32 or values.dim() != 3:
        raise ValueError(f"values must be wide (B, n, W) int32 words, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if erased.dtype != torch.bool or erased.shape != values.shape[:2]:
        raise ValueError(f"erased must be (B, n) bool matching values, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    if values.shape[1] != arrays.n:
        raise ValueError(f"frames hold {values.shape[1]} symbols, the code {arrays.n}")
    if not (values.device == erased.device == arrays.device):
        raise ValueError(f"values on {values.device}, erased on {erased.device}, "
                         f"code tables on {arrays.device}")


def ge_solve_packed(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    emax: int,
    return_rows: bool = False,
    static_topo: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Binary wide-symbol GE with packed-bit elimination.

    Args:
      values: (B, n, W) int32 frames, erased slots zero.
      erased: (B, n) bool.
      emax: the bucket of erased columns per frame (clamped to n); a frame
        with more erasures fails (overflow).
      return_rows: return the solved rows instead of placing them.
      static_topo: take the syndrome through the code's topology
        (:func:`.synd.syndrome_from_topo`, the JAX ``static_topo`` route,
        ge.py:365-377); otherwise the dense ``f2_matvec_wide``.

    Returns (values (B, n, W), erased, failed (B,) bool), or with
    ``return_rows`` (x (B, emax, W) int32 solved rows, zero on slots that
    are not written; safe_idx (B, emax) int32 target symbol of each row, n
    for discards; erased; failed), as ge.py:392-405. Solved frames have
    their erasures cleared.
    """
    _check(arrays, values, erased)
    b, n = erased.shape
    emax = min(emax, n)
    wa = -(-emax // 32)
    with profiling.span("ge.cube"):
        if erased.device.type == "cuda":
            er_idx, nreal, cube = f2_cube(arrays, erased, emax=emax)
            real = torch.arange(emax, device=erased.device)[None, :] < nreal[:, None]
        else:
            er_idx, real, nreal = erased_indices(erased, emax)
            cube = coefficient_cube(arrays, er_idx, real)
        overflow = nreal > emax
    with profiling.span("ge.elim"):
        r, pivrow, failed_k = f2_eliminate(cube, nreal, emax=emax, a_words=wa)
        failed = overflow | failed_k
    with profiling.span("ge.transforms"):
        t_rows = pivot_transforms(r, pivrow, wa)
    with profiling.span("ge.syndrome"):
        if static_topo:
            rhs = syndrome_from_topo(arrays, values)
        else:
            rhs = f2_matvec_wide(values, arrays.h_words, rows=arrays.h_rows)
    with profiling.span("ge.apply"):
        writable = real & ~overflow[:, None]
        safe_idx = torch.where(writable, er_idx, n).to(torch.int32)
        erased = erased & failed[:, None]
        if return_rows:
            # Rows that are not written come back zero: their transform rows
            # are cut before the product, so the kernel lists nothing for them.
            x = f2_matmul_batched(rhs, torch.where(writable[:, :, None], t_rows, 0))
            return x, safe_idx, erased, failed
        values = f2_apply_scatter(values, rhs, t_rows, safe_idx)
        return values, erased, failed


def _pack_bytes_words(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 4C) -> int32 words (..., C), byte j of a word in bits
    8j..8j+7 (ge.py:446-452; the little-endian view)."""
    return x.contiguous().view(torch.int32)


def _unpack_words_bytes(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., C) -> uint8 (..., 4C), LSB-first byte order."""
    return w.contiguous().view(torch.uint8)


def _syndrome_known(arrays: CodeArrays, words: torch.Tensor) -> torch.Tensor:
    """rhs = H . y_known, (B, n, W) int32 words -> (B, m, W): erased slots
    hold zero, so the coefficient MAC over all neighbours is the known-only
    sum (ge.py:63-74)."""
    b, n, w = words.shape
    vp = torch.cat([words, words.new_zeros(b, 1, w)], dim=1)  # column n reads zero
    rhs = words.new_zeros(b, arrays.m, w)
    idx = arrays.vlist_idx.long()
    for j in range(arrays.dmax):
        rhs ^= gf_mul_packed(vp[:, idx[:, j], :], arrays.vlist_val[:, j, None])
    return rhs


def _solver_words(values: torch.Tensor, gf_order: int) -> torch.Tensor:
    if gf_order == 256:
        return as_words(values, "values")
    if gf_order != 2 or values.dtype != torch.int32:
        raise ValueError(f"gf_order=2 takes int32 words, gf_order=256 uint8 bytes; got "
                         f"gf_order={gf_order}, {values.dtype}")
    return values


def ge_solve(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    emax: int,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched Gauss-Jordan with physical row swaps (ge.py:748-870), plain
    PyTorch.

    Args:
      values: (B, n, W) frames, erased slots zero: int32 words for
        ``gf_order=2``, uint8 bytes (W % 4 == 0) for ``gf_order=256``; or
        scalar (B, n) uint8 symbols, carried as one-word frames
        (:func:`.encode.scalar_words`), as JAX's ``ge_flat`` sends them here
        (hybrid.py:133-141).
      erased: (B, n) bool residual mask.
      emax: column bucket; frames with more erasures fail (overflow).

    A = (B, m + emax, emax): the erased columns of H (the coefficients for
    GF(256)) over an identity block that gives each pad slot its own row.
    Column by column the first nonzero row at or below the diagonal is
    swapped up, normalised by its inverse and eliminated from every other
    row, on A and on the right-hand side ``H . y_known``, which the
    identity leaves as the solution. The loop stops after the batch's
    widest residual (``min(max(nreal), emax)``): later columns are pad
    columns, which only swap rows at or past their own index and leave
    the solved rows, the failure flags and the placed values as they are.

    Returns (values, erased, failed) as :func:`ge_solve_packed`.
    """
    if values.dim() == 2:
        words = scalar_words(values, gf_order)
        if gf_order == 256:
            words = words.view(torch.uint8)
        out, erased, failed = ge_solve(arrays, words, erased, emax=emax, gf_order=gf_order)
        return from_scalar_words(out.view(torch.int32)), erased, failed
    words = _solver_words(values, gf_order)
    _check(arrays, words, erased)
    b, n = erased.shape
    emax = min(emax, n)
    m = arrays.m
    dev = words.device
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax
    a_top = arrays.h_nb.to(torch.int32)[:, er_idx.long()].permute(1, 0, 2) * real[:, None, :]
    eye = torch.eye(emax, dtype=torch.int32, device=dev)[None] * (~real)[:, None, :]
    a = torch.cat([a_top, eye], dim=1)  # (B, M, emax) bytes in int32
    rhs_top = _syndrome_known(arrays, words)
    rhs = torch.cat([rhs_top, words.new_zeros(b, emax, words.shape[2])], dim=1)
    mm = m + emax
    row_iota = torch.arange(mm, device=dev)[None, :]
    frames = torch.arange(b, device=dev)
    failed = overflow.clone()
    ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        cand = (a[:, :, col] != 0) & (row_iota >= col)
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), col)
        # Swap rows col and piv (a self-swap where there is no pivot).
        a_col, a_piv = a[:, col].clone(), a[frames, piv]
        a[frames, piv] = a_col
        a[:, col] = a_piv
        r_col, r_piv = rhs[:, col].clone(), rhs[frames, piv]
        rhs[frames, piv] = r_col
        rhs[:, col] = r_piv
        # Normalise the pivot row (inv(0) = 0 zeroes it where there is none).
        inv_el = gf_inv(a[:, col, col])
        prow_a = gf_mul(a[:, col], inv_el[:, None]).to(torch.int32)  # (B, emax)
        prow_r = gf_mul_packed(rhs[:, col], inv_el[:, None])  # (B, W)
        a[:, col] = prow_a
        rhs[:, col] = prow_r
        factor = torch.where((row_iota != col) & has[:, None], a[:, :, col], 0)  # (B, M)
        a ^= gf_mul(factor[:, :, None], prow_a[:, None, :]).to(torch.int32)
        rhs ^= gf_mul_packed(prow_r[:, None, :], factor[:, :, None])
        failed |= ~has & (col < nreal)
    x = rhs[:, :emax]  # the identity now fills rows 0..emax-1
    writable = real & ~overflow[:, None]
    x = x * writable[:, :, None]
    safe_idx = torch.where(writable, er_idx, n).long()
    out = torch.cat([words, words.new_zeros(b, 1, words.shape[2])], dim=1)
    out[frames[:, None].expand_as(safe_idx), safe_idx] = x
    out = out[:, :n].contiguous()
    erased = erased & failed[:, None]
    return (out.view(torch.uint8) if gf_order == 256 else out), erased, failed


def ge_rank_check(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int, gf_order: int = 2
) -> torch.Tensor:
    """Pattern-only solvability (ge.py:77-141): would the Gauss-Jordan on
    the residual succeed? Returns ``failed`` (B,) bool: rank deficient or
    more than ``emax`` erasures.

    Binary CUDA tensors launch the rank kernel (:func:`.rank.f2_rank_check`,
    ``csrc/rank.cu``), the route the JAX package documents for its
    ``ge_rank_pallas``; CPU tensors, and ``gf_order=256`` on any device, run
    :func:`ge_rank_check_reference`. The JAX package has no GF(256) rank
    kernel, so the GF(256) check stays plain tensor code here too."""
    if gf_order == 2 and erased.device.type == "cuda":
        return f2_rank_check(arrays, erased, emax=emax)
    return ge_rank_check_reference(arrays, erased, emax=emax, gf_order=gf_order)


def ge_rank_check_reference(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int, gf_order: int = 2
) -> torch.Tensor:
    """:func:`ge_solve`'s pivot loop (row swaps, pad slots on their own
    identity rows) on the erased columns of H (their GF(256) coefficients
    for ``gf_order=256``) alone, in plain PyTorch.

    The loop stops after the batch's widest residual, as :func:`ge_solve`'s:
    later columns are pad columns, which only swap a frame's identity row
    up and change no failure flag."""
    if erased.dtype != torch.bool or erased.dim() != 2 or erased.shape[1] != arrays.n:
        raise ValueError(f"erased must be (B, {arrays.n}) bool, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    b, n = erased.shape
    emax = min(emax, n)
    m = arrays.m
    dev = erased.device
    er_idx, real, nreal = erased_indices(erased, emax)
    src = arrays.h_nb if gf_order == 256 else arrays.h.to(torch.uint8)
    a_top = src[:, er_idx.long()].permute(1, 0, 2) * real[:, None, :]
    eye = torch.eye(emax, dtype=torch.uint8, device=dev)[None] * (~real)[:, None, :]
    a = torch.cat([a_top, eye], dim=1)  # (B, m + emax, emax)
    row_iota = torch.arange(m + emax, device=dev)[None, :]
    frames = torch.arange(b, device=dev)
    failed = nreal > emax
    ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        cand = (a[:, :, col] != 0) & (row_iota >= col)
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), col)
        a_col, a_piv = a[:, col].clone(), a[frames, piv]
        a[frames, piv] = a_col
        a[:, col] = a_piv
        keep = (row_iota != col) & has[:, None]
        if gf_order == 256:
            prow = gf_mul(a_piv, gf_inv(a_piv[:, col])[:, None])
            a[:, col] = prow
            factor = torch.where(keep, a[:, :, col], 0)
            a ^= gf_mul(factor[:, :, None], prow[:, None, :])
        else:
            elim = keep & (a[:, :, col] != 0)
            a ^= elim[:, :, None] * a_piv[:, None, :]
        failed |= ~has & (col < nreal)
    return failed


def coefficient_cube_nb(
    arrays: CodeArrays, er_idx: torch.Tensor, real: torch.Tensor
) -> torch.Tensor:
    """The GF(256) ``[A | T]`` rows of every frame, (B, m, wa + wt) int32,
    four bytes per word: A = the erased columns' coefficients (pad slots
    zero) in ``wa = ceil(emax/4)`` words, T = the m x m identity in
    ``wt = ceil(m/4)`` words (ge.py:551-570)."""
    b, emax = er_idx.shape
    m = arrays.m
    wa, wt = -(-emax // 4), -(-m // 4)
    a = arrays.h_nb[:, er_idx.long()].permute(1, 0, 2) * real[:, None, :]  # (B, m, emax) uint8
    a = torch.nn.functional.pad(a, (0, 4 * wa - emax))
    eye = torch.nn.functional.pad(
        torch.eye(m, dtype=torch.uint8, device=er_idx.device), (0, 4 * wt - m))
    t_pk = _pack_bytes_words(eye)  # (m, wt)
    return torch.cat([_pack_bytes_words(a), t_pk.expand(b, m, wt)], dim=2).contiguous()


def ge_solve_wide_nb(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    emax: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GF(256) wide-symbol GE: byte elimination of the narrow [A | T] cube,
    then the wide payloads touched once (ge.py:487-745).

    values (B, n, W) uint8 frames (W % 4 == 0), erased slots zero; erased
    (B, n) bool; emax the column bucket (clamped to n). The cube is
    eliminated by :func:`.elim.gf256_eliminate` with the ``a_words`` cuts;
    the syndrome ``rhs = H_nb . y`` is :func:`.nbmm.gf_matvec_wide` over the
    Vlist; ``x = T[pivot rows] . rhs`` is applied and placed in the erased
    slots by :func:`.nbmm.gf_apply_scatter`, discards (pad slots, overflow
    frames) dropped. Returns (values, erased, failed) as :func:`ge_solve`.
    """
    _check(arrays, as_words(values, "values"), erased)
    b, n = erased.shape
    emax = min(emax, n)
    m = arrays.m
    wa = -(-emax // 4)
    with profiling.span("ge.cube"):
        er_idx, real, nreal = erased_indices(erased, emax)
        overflow = nreal > emax
        cube = coefficient_cube_nb(arrays, er_idx, real)
    with profiling.span("ge.elim"):
        r, pivrow, failed_k = gf256_eliminate(cube, nreal, emax=emax, a_words=wa)
        failed = overflow | failed_k
    with profiling.span("ge.transforms"):
        t_top = _unpack_words_bytes(pivot_transforms(r, pivrow, wa))[:, :, :m].contiguous()
    with profiling.span("ge.syndrome"):
        rhs = gf_matvec_wide(values, arrays.vlist_idx, arrays.vlist_val,
                             tiles=arrays.vlist_tiles)
    with profiling.span("ge.apply"):
        writable = real & ~overflow[:, None]
        safe_idx = torch.where(writable, er_idx, n).to(torch.int32)
        values = gf_apply_scatter(values, rhs, t_top, safe_idx)
        return values, erased & failed[:, None], failed
