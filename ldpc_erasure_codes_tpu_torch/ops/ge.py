"""Batched Gauss-Jordan over GF(2) for wide binary frames: the ML erasure
solver of the hybrid decoder.

Counterpart of ``ldpc_erasure_codes_tpu/ops/ge.py``: ``erased_indices``
(:49-60) and ``ge_solve_packed`` (:162-443). The solver solves
``H_erased . x = H_known . y_known`` per frame
(Matlab/My_LDPC_HybridML_Erasure_Decoder.m:48-88) in three steps:

1. the packed coefficient cube ``[A | T]``: A holds the erased columns of H
   (``emax`` bit columns, pad slots zero), T the identity that tracks the
   row operations (m bit columns), built with plain tensor code as in XLA
   (ge.py:234-251);
2. the swap-free elimination of the cube (:mod:`.elim`, ``csrc/elim.cu``),
   which records the pivot row of each column and the failed frames;
3. the wide values touched once: the syndrome ``rhs = H . y``
   (:mod:`.synd` through the code's topology, or :mod:`.nbmm`'s dense
   ``f2_matvec_wide``), then ``x = T[pivot rows] . rhs``
   (``f2_matmul_batched`` for the rows alone, or ``f2_apply_scatter``,
   which also places them).

Pivot order, failure flags and solved values equal the JAX package's;
values of failed frames are garbage in both, and callers gate on
``failed``.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, pack_bits
from ldpc_erasure_codes_tpu_torch.ops.elim import f2_eliminate
from ldpc_erasure_codes_tpu_torch.ops.nbmm import f2_apply_scatter, f2_matmul_batched, f2_matvec_wide
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo


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
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax
    wa = -(-emax // 32)
    cube = coefficient_cube(arrays, er_idx, real)
    r, pivrow, failed_k = f2_eliminate(cube, nreal, emax=emax, a_words=wa)
    failed = overflow | failed_k
    t_rows = pivot_transforms(r, pivrow, wa)
    if static_topo:
        rhs = syndrome_from_topo(arrays, values)
    else:
        rhs = f2_matvec_wide(values, arrays.h_words)
    writable = real & ~overflow[:, None]
    safe_idx = torch.where(writable, er_idx, n).to(torch.int32)
    erased = erased & failed[:, None]
    if return_rows:
        x = f2_matmul_batched(rhs, t_rows)
        x = torch.where(writable[:, :, None], x, 0)
        return x, safe_idx, erased, failed
    values = f2_apply_scatter(values, rhs, t_rows, safe_idx)
    return values, erased, failed
