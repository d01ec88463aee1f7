"""Jacobi peeling decoders: every check tests its erasure count on the
sweep-start state, and all degree-1 checks solve at once.

Counterpart of the JAX package's non-Pallas peel decoders, which XLA runs:
``ops/peel.py::peel_decode`` with ``impl="gather"`` / ``"matmul"``
(:145-239, one ``peel_step_gather`` sweep :65-113),
``ops/peel_wide.py::peel_decode_wide`` (:92-176, the decoder that
``hybrid.py:109-115`` runs on wide frames) and ``peel_decode_mask``
(:382-433, the pattern-only decoder of the FER simulation). They are plain
tensor code here too, on the card as on the CPU.

The sweep (:func:`jacobi_sweep`) is shared by :func:`peel_decode_jacobi`,
with the JAX functions' batch-wide stop, and :func:`peel_decode_jacobi_reference`,
the plain version of the "jacobi" route of the CUDA peel (``csrc/peel.cu``,
its schedule kernel in the Jacobi order, then the slab value kernel), with
the kernel's per-frame stop. A degree-1 check's value is the sum of its
other neighbours (GF(256): their coefficient-weighted sum times the
inverse of the erased slot's coefficient). Where two degree-1 checks solve
the same symbol in one sweep, the higher-numbered check's value is kept
(the kernel's schedule makes it the symbol's one owner); on a codeword all
such values are equal, so the outputs equal the JAX decoders' (which OR the
candidates together, or scatter one of them).

Stop and count rules of the JAX loop (peel.py:189-238; peel_wide.py and
peel_decode_mask keep the same): sweeps run while some frame is not done
and the last sweep cleared an erasure somewhere in the batch, at most
``max_iters``; a frame's count is the first sweep after which it is done
(its first ``early_stop_k`` symbols known, all n without early stop); a
frame that never finishes counts ``max_iters``; a frame done before the
first sweep counts 1. Done frames keep sweeping while others run, so with
``early_stop_k`` their parity-region residual depends on the batch; the
per-frame stop of the reference decoder agrees with it on the iteration
counts, the first-k mask and every resolved value.
"""

from __future__ import annotations

from typing import Callable

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.encode import from_scalar_words, scalar_words

Sweep = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def as_frames(values: torch.Tensor, gf_order: int):
    """(words (B, n, W) int32, back) for the symbols the decoders take:
    scalar (B, n) uint8 symbols (one word each, :func:`.encode.scalar_words`),
    wide binary (B, n, W) int32 words, or wide GF(256) (B, n, W) uint8
    bytes (zero-padded to whole words). ``back`` turns decoded words into
    the input's form."""
    if gf_order not in (2, 256):
        raise ValueError(f"gf_order must be 2 or 256, got {gf_order}")
    if values.dim() == 2:
        return scalar_words(values, gf_order), from_scalar_words
    if values.dim() != 3:
        raise ValueError(f"values must be (B, n) or (B, n, W), got {tuple(values.shape)}")
    if gf_order == 2:
        if values.dtype != torch.int32:
            raise TypeError(f"binary wide values must be torch.int32 words, got {values.dtype}")
        return values.contiguous(), lambda w: w
    if values.dtype != torch.uint8:
        raise TypeError(f"GF(256) wide values must be torch.uint8 bytes, got {values.dtype}")
    wb = values.shape[2]
    padded = torch.nn.functional.pad(values, (0, -wb % 4)).contiguous()
    return padded.view(torch.int32), lambda w: w.contiguous().view(torch.uint8)[..., :wb]


def _check(arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, max_iters: int,
           early_stop_k: int | None) -> int:
    b, n, _ = words.shape
    if erased.dtype != torch.bool or erased.shape != (b, n):
        raise ValueError(f"erased must be (B, n) = {(b, n)} bool, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    if n < arrays.min_n:
        raise ValueError(f"n={n} is shorter than the code's columns ({arrays.min_n})")
    if not (words.device == erased.device == arrays.device):
        raise ValueError(f"values on {words.device}, erased on {erased.device}, "
                         f"code tables on {arrays.device}")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} must be >= 0")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    if not 0 <= k_stop <= n:
        raise ValueError(f"early_stop_k={early_stop_k} outside 0..{n}")
    return k_stop


def jacobi_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, gf_order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep of (B, n, W) int32 words (erased slots zero) and the
    (B, n) mask; returns new (words, erased)."""
    b, n, w = words.shape
    m = arrays.m
    idx = arrays.vlist_idx.long()  # (m, dmax), pad = n
    vp = torch.cat([words, words.new_zeros(b, 1, w)], dim=1)  # column n reads zero
    ep = torch.cat([erased, erased.new_zeros(b, 1)], dim=1)
    ev = ep[:, idx]  # (B, m, dmax)
    deg1 = ev.sum(dim=2) == 1
    acc = words.new_zeros(b, m, w)
    for j in range(arrays.dmax):
        term = vp[:, idx[:, j]]  # (B, m, W)
        if gf_order == 256:
            term = gf_mul_packed(term, arrays.vlist_val[:, j, None])
        acc ^= term
    if gf_order == 256:
        inv = (ev * arrays.vlist_inv_val[None]).sum(dim=2)  # the erased slot's (degree 1)
        acc = gf_mul_packed(acc, inv[..., None])
    # The erased neighbour of each degree-1 check; its highest such check
    # owns the symbol (the others write the same value on a codeword).
    target = torch.where(deg1, (ev * idx[None]).sum(dim=2), n)
    checks = torch.arange(m, device=words.device).expand(b, m).contiguous()
    owner = torch.full((b, n + 1), -1, dtype=torch.long, device=words.device)
    owner = owner.scatter_reduce(1, target, checks, reduce="amax")[:, :n]
    solved = owner >= 0
    got = acc.gather(1, owner.clamp(min=0)[..., None].expand(b, n, w))
    return torch.where(solved[..., None], got, words), erased & ~solved


def batch_loop(
    sweep: Sweep, words: torch.Tensor, erased: torch.Tensor, *, max_iters: int, k_stop: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX decoders' loop (peel.py:189-238) around ``sweep``: batch-wide
    stop, per-frame counts. Two host reads per sweep."""
    b = erased.shape[0]
    done0 = ~erased[:, :k_stop].any(dim=1)
    iters = torch.zeros((b,), dtype=torch.int32, device=erased.device)
    prev = None
    for it in range(max_iters):
        if not bool(erased[:, :k_stop].any()):
            break
        cur = int(erased.sum())
        if prev is not None and cur >= prev:
            break
        prev = cur
        words, erased = sweep(words, erased)
        newly = ~erased[:, :k_stop].any(dim=1) & (iters == 0)
        iters = torch.where(newly, it + 1, iters)
    iters = torch.where(iters == 0, max_iters, iters)
    iters = torch.where(done0, 1, iters).to(torch.int32)
    return words, erased, iters


def peel_decode_jacobi(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    gf_order: int = 2,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Jacobi peeling decode of ``peel_decode(impl="gather")`` and
    ``peel_decode_wide``: scalar (B, n) uint8 symbols or wide (B, n, W)
    frames (int32 words for ``gf_order=2``, uint8 bytes for 256).

    ``values`` may be the un-erased channel output: erased slots are zeroed
    first. Returns (values, erased, iters) in the input's form; erased slots
    left unsolved hold zero.
    """
    words, back = as_frames(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    words = words.masked_fill(erased[..., None], 0)
    out, er, iters = batch_loop(
        lambda v, e: jacobi_sweep(arrays, v, e, gf_order), words, erased,
        max_iters=max_iters, k_stop=k_stop,
    )
    return back(out), er, iters


def peel_decode_jacobi_reference(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the "jacobi" peel kernel: :func:`jacobi_sweep` with
    the kernel's per-frame stop. A frame stops after the first sweep that
    leaves its first ``early_stop_k`` symbols known (its count is that
    sweep) or that changes nothing (its count is ``max_iters``), so its
    later sweeps never run. Takes the kernel's frames: (B, n, W) int32 words
    (binary) or uint8 bytes with W % 4 == 0 (GF(256)); returns the same
    form."""
    words, back = as_frames(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    b = words.shape[0]
    er = erased.clone()
    v = words.masked_fill(er[..., None], 0)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=v.device)
    active = torch.ones((b,), dtype=torch.bool, device=v.device)
    for it in range(max_iters):
        live = active.nonzero().squeeze(1)
        v_new, e_new = jacobi_sweep(arrays, v[live], er[live], gf_order)
        changed = (e_new != er[live]).any(dim=1)
        v[live], er[live] = v_new, e_new
        fin = ~e_new[:, :k_stop].any(dim=1)
        iters[live[fin]] = it + 1
        active[live] = ~fin & changed
        if not bool(active.any()):
            break
    return back(v), er, iters


def mask_sweep(arrays: CodeArrays, erased: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep of the mask alone, as two products with H
    (peel.py:411-421) in float32, where counts up to the check and symbol
    degrees are exact."""
    h = arrays.h.to(torch.float32)  # (m, n)
    cnt = erased.to(torch.float32) @ h.t()  # (B, m) erased neighbours
    touched = (cnt == 1).to(torch.float32) @ h  # (B, n) degree-1 checks per symbol
    return erased & ~(touched > 0)


def peel_decode_mask(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pattern-only peeling (peel.py:382-433): the mask evolves as in the
    value decode, which it does not depend on. Returns (residual mask,
    iters)."""
    b, n = erased.shape
    if erased.dtype != torch.bool or n != arrays.n or erased.device != arrays.device:
        raise ValueError(f"erased must be (B, {arrays.n}) bool on {arrays.device}, got "
                         f"{tuple(erased.shape)} {erased.dtype} on {erased.device}")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    _, er, iters = batch_loop(
        lambda v, e: (v, mask_sweep(arrays, e)), erased, erased,
        max_iters=max_iters, k_stop=k_stop,
    )
    return er, iters
