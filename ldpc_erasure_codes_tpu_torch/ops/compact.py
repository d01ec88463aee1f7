"""Residual-frame compaction for the Gauss-Jordan fallback.

Counterpart of ``ldpc_erasure_codes_tpu/ops/compact.py``: ``residual_order``
(:25-37), ``compact_ge_rank`` (:40-55) and ``compact_ge_solve`` (:58-106). After
peeling, only the frames stuck in a stopping set need elimination; they are
gathered into a bucket of ``f_max`` frames, solved there and scattered
back. Residual frames beyond the bucket are flagged failed (overflow).
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.ge import (
    ge_rank_check,
    ge_solve,
    ge_solve_packed,
    ge_solve_wide_nb,
)
from ldpc_erasure_codes_tpu_torch.utils import profiling


def residual_order(
    erased: torch.Tensor, f_max: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of the residual frames, padded to ``f_max``.

    Returns (sel (min(f_max, B),) int64 frame indices: residual frames
    first in ascending order, then non-residual fillers; is_resid, bool,
    the same length; overflow (B,) bool, residual frames that did not fit).
    """
    resid = erased.any(dim=1)
    order = torch.argsort((~resid).to(torch.uint8), stable=True)
    sel = order[:f_max]
    is_resid = resid[sel]
    rank = torch.cumsum(resid.to(torch.int32), dim=0) - 1  # position among residuals
    overflow = resid & (rank >= f_max)
    return sel, is_resid, overflow


def compact_ge_rank(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int, f_max: int, gf_order: int = 2
) -> torch.Tensor:
    """:func:`.ge.ge_rank_check` on the residual sub-batch only; returns
    failed (B,), overflow included."""
    sel, is_resid, overflow = residual_order(erased, f_max)
    failed_sub = ge_rank_check(arrays, erased[sel], emax=emax, gf_order=gf_order)
    failed = torch.zeros((erased.shape[0],), dtype=torch.bool, device=erased.device)
    failed[sel] = failed_sub & is_resid
    return failed | overflow


def ge_packed(ge_impl: str, gf_order: int, values: torch.Tensor) -> bool:
    """Whether ``ge_impl`` picks the field's wide-word solver for these
    frames (:func:`solve_packed`): "packed" on wide frames of either field,
    and "auto" on wide binary words and on wide GF(256) bytes whose width
    is whole words (W % 4 == 0); "bytes", and "auto" on other frames, pick
    the byte solver :func:`.ge.ge_solve`. For binary words this is JAX's
    choice (compact.py:77-86, hybrid.py:131-137). JAX sends GF(256) bytes
    to its byte solver under "auto" and runs the binary solver on them
    under "packed"; the port runs GF(256)'s wide-word solver under both,
    which returns the byte solver's erasures and flags, and its values on
    every frame that does not fail. Raises for an unknown ``ge_impl`` and
    for "packed" on scalar (B, n) frames."""
    if ge_impl not in ("auto", "packed", "bytes"):
        raise ValueError(f"unknown ge_impl {ge_impl!r}: expected auto | packed | bytes")
    wide = values.dim() == 3
    if ge_impl == "packed" and not wide:
        raise ValueError("ge_impl='packed' takes wide frames only")
    if ge_impl == "auto":
        return wide and (gf_order == 2 or values.shape[2] % 4 == 0)
    return ge_impl == "packed"


def solve_packed(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, *, emax: int, gf_order: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The field's wide-word solver: :func:`.ge.ge_solve_packed` for binary
    int32 words, :func:`.ge.ge_solve_wide_nb` for GF(256) uint8 bytes. Both
    want the erased slots at zero and return (values, erased, failed) as
    :func:`.ge.ge_solve`."""
    if gf_order == 256:
        return ge_solve_wide_nb(arrays, values, erased, emax=emax)
    return ge_solve_packed(arrays, values, erased, emax=emax)


def compact_ge_solve(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    emax: int,
    f_max: int,
    gf_order: int = 2,
    ge_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GE on the residual sub-batch, scattered back.

    ``values`` hold the erased slots at zero (the peel's output does).
    ``ge_impl`` picks the solver (:func:`ge_packed`): "auto" and "packed"
    send wide frames to the field's wide-word solver (:func:`solve_packed`):
    binary int32 words to :func:`.ge.ge_solve_packed`, with the dense
    ``f2_matvec_wide`` syndrome and the ``f2_apply_scatter`` placement, as
    the JAX function calls the solver without a topology, and GF(256) uint8
    bytes to :func:`.ge.ge_solve_wide_nb`, the card's GF(256) GE kernels,
    where JAX's compact.py:77-93 takes its byte solver; "bytes", and "auto"
    on scalar (B, n) symbols, send every frame to :func:`.ge.ge_solve`.
    Returns new (values, erased, failed), the same from every solver but
    for the values of failed frames, which keep all their erasures. The
    filler frames of the bucket have no erasures, so the solver returns
    them unchanged and the whole sub-batch scatters back
    (compact.py:94-101).
    """
    b = erased.shape[0]
    packed = ge_packed(ge_impl, gf_order, values)
    with profiling.span("ge.gather"):
        sel, is_resid, overflow = residual_order(erased, f_max)
        v_sub, e_sub = values[sel], erased[sel]
    if packed:
        v_sub, e_sub, failed_sub = solve_packed(arrays, v_sub, e_sub, emax=emax,
                                                gf_order=gf_order)
    else:
        v_sub, e_sub, failed_sub = ge_solve(arrays, v_sub, e_sub, emax=emax, gf_order=gf_order)
    with profiling.span("ge.scatter"):
        values = values.index_copy(0, sel, v_sub)
        erased = erased.index_copy(0, sel, torch.where(is_resid[:, None], e_sub, erased[sel]))
        failed = torch.zeros((b,), dtype=torch.bool, device=erased.device)
        failed[sel] = failed_sub & is_resid
        return values, erased, failed | overflow
