"""Hybrid MPA + ML decoder: peel first, Gauss-Jordan the residual.

Counterpart of ``ldpc_erasure_codes_tpu/ops/hybrid.py``: ``hybrid_decode``
(:42-222) and ``hybrid_decode_escalated`` (:225-308), wide binary frames
(int32 words), GF(256) frames (uint8 bytes) and scalar (B, n) uint8
symbols of either field.
Peeling removes the bulk of the erasures; the rare residual stopping set is
solved exactly by the packed GE (the reference's
Matlab/My_LDPC_HybridML_Erasure_Decoder.m:3-91). The hybrid beats the
equivalent-rate Reed-Solomon code at every tested erasure rate (paper
tex:164).
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.compact import (
    compact_ge_solve,
    ge_packed,
    residual_order,
    solve_packed,
)
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_solve, ge_solve_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi, peel_decode_wide
from ldpc_erasure_codes_tpu_torch.utils import profiling


def _peel(arrays, values, erased, *, gf_order, peel_iters, impl, tiled):
    """The peel stage, in JAX's three branches (hybrid.py:84-123):
    ``impl="vmem"`` on wide frames is the sequential peel kernel
    (``peel_decode``), ``"gather"`` on wide frames the wide Jacobi peel
    (:func:`.peel_jacobi.peel_decode_wide`), and everything else
    :func:`.peel_jacobi.peel_decode_jacobi` with ``impl`` ("vmem" read as
    "gather"), which refuses what JAX's ``peel_decode`` refuses."""
    if tiled and impl != "vmem":
        raise ValueError("tiled=True requires impl='vmem'")
    if values.dim() == 3 and impl == "vmem":
        return peel_decode(arrays, values, erased, max_iters=peel_iters, gf_order=gf_order)
    if values.dim() == 3 and impl == "gather":
        return peel_decode_wide(arrays, values, erased, max_iters=peel_iters, gf_order=gf_order)
    return peel_decode_jacobi(arrays, values, erased, max_iters=peel_iters, gf_order=gf_order,
                              impl="gather" if impl == "vmem" else impl)


def _ge_rows(arrays, values, erased, *, emax, ge_subbatch, static_topo):
    """The flat counterpart of JAX's tile-direct branch (hybrid.py:158-195):
    gather the residual frames, solve for their rows, and write the rows
    straight into ``values`` and ``erased`` in place (both are the peel's
    fresh outputs). Discarded rows (target n) are skipped."""
    b, n = erased.shape
    with profiling.span("ge.gather"):
        sel, is_resid, overflow = residual_order(erased, ge_subbatch)
        v_sub, e_sub = values[sel], erased[sel]
    x, sidx, e_sub, failed_sub = ge_solve_packed(
        arrays, v_sub, e_sub, emax=emax, return_rows=True, static_topo=static_topo,
    )
    with profiling.span("ge.scatter"):
        keep = sidx < n
        frames = sel[:, None].expand_as(sidx)[keep]
        values[frames, sidx[keep].long()] = x[keep]
        erased[sel] = torch.where(is_resid[:, None], e_sub, erased[sel])
        failed = torch.zeros((b,), dtype=torch.bool, device=erased.device)
        failed[sel] = failed_sub & is_resid
        return values, erased, failed | overflow


def hybrid_decode(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    gf_order: int = 2,
    peel_iters: int = 10,
    emax: int = 128,
    impl: str = "gather",
    ge_subbatch: int = 0,
    tiled: bool = False,
    ge_impl: str = "auto",
    static_topo: bool = False,
    return_overflow: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Peel up to ``peel_iters`` sweeps, then GE-solve the residual.

    ``values`` (B, n, W) int32 words (binary), uint8 bytes (GF(256)) or
    scalar (B, n) uint8 symbols may be the un-erased channel output: the
    peel zeroes the erased slots. ``impl`` picks the peel as JAX does
    (hybrid.py:84-123, :func:`_peel`): ``"vmem"`` takes the sequential peel
    kernel for wide frames (and ``tiled=True`` requires it); ``"gather"``
    (JAX's default) the wide Jacobi peel; ``"matmul"`` and ``"worklist"``,
    and every scalar frame, :func:`.peel_jacobi.peel_decode_jacobi` with
    that ``impl``. Iteration counts are those of the chosen schedule; an
    ``impl`` JAX refuses raises ValueError. ``emax`` buckets the residual
    GE width; frames whose residual exceeds it fail. ``ge_subbatch`` > 0
    compacts the frames that still hold erasures into a bucket of that many
    frames (overflow -> failed). ``ge_impl`` picks the solver as
    :func:`.compact.ge_packed` says: "auto" and "packed" the field's
    wide-word solver on wide frames (:func:`.compact.solve_packed`:
    ``ge_solve_packed`` for binary words, as JAX's ``ge_flat``,
    hybrid.py:127-141, and GF(256)'s ``ge_solve_wide_nb``, the card's
    GF(256) GE kernels, for bytes, where JAX takes its byte solver), the
    byte ``ge_solve`` for scalar frames under "auto" ("packed" raises
    there), "bytes" the byte one always. Every solver returns the same
    erasures and flags, and the same values on frames that do not fail.
    The knobs are the JAX function's; the port keeps the flat layout, so:

    * ``tiled=True`` with ``ge_subbatch`` > 0 on a binary code with
      ``ge_impl`` "auto" or "packed" takes the flat counterpart of JAX's
      tile-direct branch (the production one, hybrid.py:158-162): the
      solved rows (``ge_solve_packed(return_rows=True)``) are written
      straight into the decoded frames. Otherwise, and for GF(256) always,
      the residual goes through :func:`.compact.compact_ge_solve`
      (``ge_subbatch`` > 0) or the chosen solver on the whole batch, as
      JAX's ``ge_flat``. The frames that either hands to
      ``ge_solve_wide_nb`` (the bucket, fillers included) are counted as
      ``hybrid.ge.nb_wide_frames``.
    * ``static_topo=True`` takes the row branch's syndrome through the code's
      topology (``csrc/synd.cu``) instead of the dense product.

    JAX's ``jax.lax.cond(any_residual, ...)`` is one host check per decode
    here: a batch that peeled clean skips the GE and costs one sync.

    Returns (values, erased, iters, failed); with ``return_overflow=True``
    a 5th (B,) bool marks the frames failed by bucket configuration
    (residual wider than ``emax``, or spilled past the ``ge_subbatch``
    bucket), the frames :func:`hybrid_decode_escalated` re-dispatches.
    """
    with profiling.span("hybrid.decode", device=values.device):
        return _hybrid(arrays, values, erased, gf_order=gf_order, peel_iters=peel_iters,
                       emax=emax, impl=impl, ge_subbatch=ge_subbatch, tiled=tiled,
                       ge_impl=ge_impl, static_topo=static_topo,
                       return_overflow=return_overflow)


def _hybrid(arrays, values, erased, *, gf_order, peel_iters, emax, impl, ge_subbatch, tiled,
            ge_impl, static_topo, return_overflow):
    """:func:`hybrid_decode`'s body, inside the caller's ``hybrid.decode`` span."""
    packed = ge_packed(ge_impl, gf_order, values)
    with profiling.span("hybrid.peel"):
        values, erased, iters = _peel(arrays, values, erased, gf_order=gf_order,
                                      peel_iters=peel_iters, impl=impl, tiled=tiled)
    b, n = erased.shape
    if profiling.enabled():  # enqueued before the sync, while the card peels
        nres = erased.any(dim=1).sum()
        profiling.count("hybrid.residual_frames", nres)
        if ge_subbatch > 0:
            profiling.count("hybrid.bucket_overflow_frames", (nres - ge_subbatch).clamp_(min=0))
    with profiling.span("hybrid.sync.residual"):
        residual = bool(erased.any())
    if not residual:
        z = torch.zeros((b,), dtype=torch.bool, device=erased.device)
        return (values, erased, iters, z, z) if return_overflow else (values, erased, iters, z)
    if return_overflow:  # from the peel's mask, before the GE clears it
        overflow = erased.sum(dim=1) > min(emax, n)
        if ge_subbatch > 0:
            overflow |= residual_order(erased, ge_subbatch)[2]
    if packed and gf_order == 256:
        profiling.count("hybrid.ge.nb_wide_frames", min(ge_subbatch, b) if ge_subbatch > 0 else b)
    if tiled and ge_subbatch > 0 and packed and gf_order == 2:
        with profiling.span("hybrid.ge.rows"):
            values, erased, failed = _ge_rows(
                arrays, values, erased, emax=emax, ge_subbatch=ge_subbatch,
                static_topo=static_topo,
            )
    elif ge_subbatch > 0:
        with profiling.span("hybrid.ge.compact"):
            values, erased, failed = compact_ge_solve(
                arrays, values, erased, emax=emax, f_max=ge_subbatch, gf_order=gf_order,
                ge_impl=ge_impl,
            )
    else:
        with profiling.span("hybrid.ge.whole"):
            if packed:
                values, erased, failed = solve_packed(arrays, values, erased, emax=emax,
                                                      gf_order=gf_order)
            else:
                values, erased, failed = ge_solve(
                    arrays, values, erased, emax=emax, gf_order=gf_order)
    if return_overflow:
        return values, erased, iters, failed, overflow
    return values, erased, iters, failed


def hybrid_decode_escalated(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    gf_order: int = 2,
    peel_iters: int = 10,
    emax: int = 128,
    impl: str = "gather",
    ge_subbatch: int = 0,
    ge_impl: str = "auto",
    static_topo: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """:func:`hybrid_decode` (flat branch) with bucket-overflow escalation.

    Frames flagged failed that still hold erasures are solved again in a
    second dispatch whose buckets come from the actual residuals, so the
    bucket sizes cost speed and never a result; frames that are rank
    deficient fail again. The bucket arithmetic is JAX's
    (hybrid.py:281-307): ``emax2`` = the largest residual rounded up to a
    multiple of 128, at most n; ``b2`` = a power of two >= 8 frames, padded
    with the first candidate; erased slots re-zeroed before the dispatch.
    The second dispatch is ``ge_solve_packed``, ``ge_solve_wide_nb`` for
    GF(256) and ``ge_solve`` for scalar symbols (hybrid.py:294-301).
    ``ge_impl`` passes to the first dispatch, so "auto" and "packed" run
    both dispatches of GF(256) bytes on ``ge_solve_wide_nb``. That dispatch
    takes the flat branch (``compact_ge_solve``, or the whole batch), which
    reads no ``static_topo``: the argument is accepted for JAX's signature
    and has no effect here.

    Returns (values, erased, iters, failed, n_escalated), n_escalated the
    frames that entered the second dispatch. Syncs with the host.
    """
    with profiling.span("hybrid.decode", device=values.device):
        values, erased, iters, failed = _hybrid(
            arrays, values, erased, gf_order=gf_order, peel_iters=peel_iters, emax=emax,
            impl=impl, ge_subbatch=ge_subbatch, tiled=False, ge_impl=ge_impl,
            static_topo=static_topo, return_overflow=False,
        )
        with profiling.span("hybrid.sync.failed"):
            any_failed = bool(failed.any())
        if not any_failed:
            return values, erased, iters, failed, 0
        with profiling.span("hybrid.escalate"):
            return _escalate(arrays, values, erased, iters, failed, gf_order=gf_order)


def _escalate(arrays, values, erased, iters, failed, *, gf_order):
    """:func:`hybrid_decode_escalated`'s second dispatch, inside its
    ``hybrid.escalate`` span."""
    with profiling.span("hybrid.sync.candidates"):
        resid = erased.sum(dim=1)
        cand = torch.nonzero(failed & (resid > 0)).squeeze(1)
    ncand = cand.numel()
    if ncand == 0:
        return values, erased, iters, failed, 0
    n = erased.shape[1]
    with profiling.span("hybrid.sync.emax"):
        emax2 = min(n, -(-int(resid[cand].max()) // 128) * 128)
    b2 = max(8, 1 << (ncand - 1).bit_length())
    profiling.count("hybrid.escalated_frames", ncand)
    profiling.count("hybrid.escalation_frames_padded", b2)
    profiling.count("hybrid.escalation_emax", emax2)
    with profiling.span("ge.gather"):
        sel = torch.cat([cand, cand[:1].expand(b2 - ncand)])
        e_sub = erased[sel]
        v_sub = values[sel].masked_fill_(e_sub if values.dim() == 2 else e_sub[:, :, None], 0)
    if values.dim() == 2:
        v2, e2, f2 = ge_solve(arrays, v_sub, e_sub, emax=emax2, gf_order=gf_order)
    else:
        v2, e2, f2 = solve_packed(arrays, v_sub, e_sub, emax=emax2, gf_order=gf_order)
    with profiling.span("ge.scatter"):
        values[cand] = v2[:ncand]
        erased[cand] = e2[:ncand]
        failed[cand] = f2[:ncand]
    return values, erased, iters, failed, ncand
