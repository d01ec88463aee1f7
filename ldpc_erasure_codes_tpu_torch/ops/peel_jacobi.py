"""Jacobi peeling decoders: every check tests its erasure count on the
sweep-start state, and all degree-1 checks solve at once.

Counterpart of the JAX package's non-Pallas peel decoders, which XLA runs:
``ops/peel.py::peel_decode`` (:139-239) with its ``impl``, ``worklist_size``
and ``seq_blocks`` (:func:`peel_decode_jacobi`), its single sweeps
``peel_step_gather`` (:65-113), ``peel_step_matmul`` (:116-136),
``peel_step_seq_blocks`` (:242-306) and ``peel_step_worklist`` (:309-376),
``peel_decode_mask`` (:382-433, the pattern-only decoder of the FER
simulation) and ``peel_decode_with_history`` (:436-462), and
``ops/peel_wide.py::peel_decode_wide`` (:92-176, the decoder that
``hybrid.py:109-115`` runs on wide frames, with its ``split``). They are
plain tensor code here too, on the card as on the CPU, except
:func:`peel_decode_mask`, which launches ``csrc/peel_mask.cu`` for CUDA
tensors (:func:`peel_decode_mask_reference` is its plain version).

The Jacobi sweep (:func:`jacobi_sweep`) is shared by
:func:`peel_decode_jacobi`, with the JAX functions' batch-wide stop, and
:func:`peel_decode_jacobi_reference`, the plain version of the "jacobi"
route of the CUDA peel (``csrc/peel.cu``, its schedule kernel in the Jacobi
order, then the slab value kernel), with the kernel's per-frame stop. A
degree-1 check's value is the sum of its other neighbours (GF(256): their
coefficient-weighted sum times the inverse of the erased slot's
coefficient), summed one neighbour slot at a time (:func:`check_values`).
Where two degree-1 checks solve the same symbol in one sweep, the
higher-numbered check's value is kept (the kernel's schedule makes it the
symbol's one owner); the block and worklist sweeps keep the later check of
their set the same way. On a codeword all such values are equal, so the
outputs equal the JAX decoders' (which OR the candidates together, or
scatter one of them). :func:`peel_step_gather` ORs them as JAX does, and
equals JAX's step on any input.

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

from functools import partial
from typing import Callable

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.encode import from_scalar_words, scalar_words
from ldpc_erasure_codes_tpu_torch.utils import profiling

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


def check_values(
    vp: torch.Tensor, ep: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
    inv: torch.Tensor, gf_order: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The value each check of a set would give its erased neighbour, and
    the erased flags of its neighbours: (acc (B, R, W), ev (B, R, dmax)).

    ``vp`` (B, n + 1, W) and ``ep`` (B, n + 1) are the words and the mask
    with a zero column n; ``idx`` / ``val`` / ``inv`` the checks' Vlist
    rows, their coefficients and inverses, (R, dmax) for one set of checks
    or (B, R, dmax) for one per frame. ``acc`` is the sum of all neighbours
    (erased slots hold zero; GF(256): the coefficient-weighted sum times
    the inverse of the erased slot's coefficient, meaningful where exactly
    one neighbour is erased). The sum runs over the ``dmax`` slots one at
    a time, so no (B, R, dmax, W) gather is made."""
    b, _, w = vp.shape
    if idx.dim() == 2:
        ev = ep[:, idx]
    else:
        ev = ep.gather(1, idx.reshape(b, -1)).reshape(idx.shape)
    acc = vp.new_zeros(b, idx.shape[-2], w)
    for j in range(idx.shape[-1]):
        if idx.dim() == 2:
            term = vp[:, idx[:, j]]
        else:
            term = vp.gather(1, idx[:, :, j, None].expand(-1, -1, w))
        if gf_order == 256:
            term = gf_mul_packed(term, val[..., j, None])
        acc ^= term
    if gf_order == 256:
        acc = gf_mul_packed(acc, (ev * inv).sum(dim=-1)[..., None])
    return acc, ev


def _padded(words: torch.Tensor, erased: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, _, w = words.shape
    return (torch.cat([words, words.new_zeros(b, 1, w)], dim=1),
            torch.cat([erased, erased.new_zeros(b, 1)], dim=1))


def jacobi_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, gf_order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep of (B, n, W) int32 words (erased slots zero) and the
    (B, n) mask; returns new (words, erased)."""
    b, n, w = words.shape
    m = arrays.m
    idx = arrays.vlist_idx.long()  # (m, dmax), pad = n
    vp, ep = _padded(words, erased)  # column n reads zero
    acc, ev = check_values(vp, ep, idx, arrays.vlist_val, arrays.vlist_inv_val[None], gf_order)
    deg1 = ev.sum(dim=2) == 1
    # The erased neighbour of each degree-1 check; its highest such check
    # owns the symbol (the others write the same value on a codeword).
    target = torch.where(deg1, (ev * idx[None]).sum(dim=2), n)
    checks = torch.arange(m, device=words.device).expand(b, m).contiguous()
    owner = torch.full((b, n + 1), -1, dtype=torch.long, device=words.device)
    owner = owner.scatter_reduce(1, target, checks, reduce="amax")[:, :n]
    solved = owner >= 0
    got = acc.gather(1, owner.clamp(min=0)[..., None].expand(b, n, w))
    return torch.where(solved[..., None], got, words), erased & ~solved


def gather_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, gf_order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``peel_step_gather`` (peel.py:65-113) on (B, n, W) int32 words:
    each erased symbol with a degree-1 check takes the OR of the values of
    all its degree-1 checks, read through the Clist. Erased slots are read
    as they are: JAX's contract is that they hold zero."""
    b, n, w = words.shape
    vp, ep = _padded(words, erased)
    acc, ev = check_values(vp, ep, arrays.vlist_idx.long(), arrays.vlist_val,
                           arrays.vlist_inv_val[None], gf_order)
    deg1 = ev.sum(dim=2) == 1
    valp = torch.cat([torch.where(deg1[..., None], acc, 0), acc.new_zeros(b, 1, w)], dim=1)
    deg1p = torch.cat([deg1, deg1.new_zeros(b, 1)], dim=1)  # row m: the Clist's pad
    cidx = arrays.clist_idx.long()  # (n, cmax), pad = m
    newval = torch.zeros_like(words)
    for j in range(cidx.shape[1]):
        newval |= valp[:, cidx[:, j]]
    solved = deg1p[:, cidx].any(dim=2) & erased
    return torch.where(solved[..., None], newval, words), erased & ~solved


def matmul_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``peel_step_matmul`` (peel.py:116-136) on one-word binary
    symbols (B, n, 1): erased counts, parities and votes as three products
    with H in float32, where counts up to the degrees are exact. A solved
    symbol becomes the 0/1 vote of its degree-1 checks."""
    h = arrays.h.to(torch.float32)  # (m, n)
    cnt = erased.to(torch.float32) @ h.t()  # (B, m)
    par = ((words[..., 0] & 1).to(torch.float32) @ h.t()) % 2
    deg1 = cnt == 1
    nsolv = deg1.to(torch.float32) @ h  # (B, n)
    votes = (deg1 & (par == 1)).to(torch.float32) @ h
    solved = (nsolv > 0) & erased
    bit = (votes > 0).to(words.dtype)[..., None]
    return torch.where(solved[..., None], bit, words), erased & ~solved


def _write_solved(vp: torch.Tensor, ep: torch.Tensor, acc: torch.Tensor, ev: torch.Tensor,
                  idx: torch.Tensor, deg1: torch.Tensor) -> None:
    """Write each degree-1 check's value into its one erased neighbour, in
    place in the padded ``vp`` / ``ep``. Where two checks of the set solve
    one symbol, the later one in the set is written (on a codeword they
    agree; JAX's scatter leaves the choice to XLA)."""
    b, n1, w = vp.shape
    rows = acc.shape[1]
    target = torch.where(deg1, (ev * idx).sum(dim=-1), n1 - 1)
    if rows > 1:  # one check cannot collide with itself
        r = torch.arange(rows, device=vp.device).expand(b, rows)
        owner = torch.full((b, n1), -1, dtype=torch.long, device=vp.device)
        owner = owner.scatter_reduce(1, target, r, reduce="amax")
        deg1 = deg1 & (owner.gather(1, target) == r)
        target = torch.where(deg1, target, n1 - 1)
    # Every other check writes zero into the pad column n.
    vp.scatter_(1, target[..., None].expand(b, rows, w), torch.where(deg1[..., None], acc, 0))
    ep.scatter_(1, target, False)


def block_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, gf_order: int,
    bounds: list[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep as sequential check blocks ``bounds[i]:bounds[i + 1]``:
    each block is Jacobi on the state at its start and writes each
    degree-1 check's value to its erased neighbour (peel.py:242-306,
    peel_wide.py:36-89)."""
    n = words.shape[1]
    vp, ep = _padded(words, erased)
    idx = arrays.vlist_idx.long()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        acc, ev = check_values(vp, ep, idx[lo:hi], arrays.vlist_val[lo:hi],
                               arrays.vlist_inv_val[None, lo:hi], gf_order)
        _write_solved(vp, ep, acc, ev, idx[lo:hi], ev.sum(dim=2) == 1)
    return vp[:, :n], ep[:, :n]


def worklist_sweep(
    arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, gf_order: int,
    worklist: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``peel_step_worklist`` (peel.py:309-376): per frame, the first
    ``worklist`` degree-1 checks in ascending check order (a stable sort of
    ``~deg1``, cut) solve their erased neighbours; the rest wait for the
    next sweep."""
    n = words.shape[1]
    vp, ep = _padded(words, erased)
    idx = arrays.vlist_idx.long()
    deg1 = ep[:, idx].sum(dim=2) == 1  # (B, m)
    order = torch.argsort((~deg1).to(torch.uint8), dim=1, stable=True)[:, :worklist]
    rows = idx[order]  # (B, A, dmax)
    acc, ev = check_values(vp, ep, rows, arrays.vlist_val[order],
                           arrays.vlist_inv_val[order], gf_order)
    _write_solved(vp, ep, acc, ev, rows, deg1.gather(1, order))
    return vp[:, :n], ep[:, :n]


def seq_block_bounds(m: int, seq_blocks: int) -> list[int]:
    """``peel_step_seq_blocks``' blocks: ``ceil(m / seq_blocks)`` checks
    each, the last padded (its pad rows solve nothing)."""
    mb = -(-m // seq_blocks)
    return [min(i * mb, m) for i in range(seq_blocks + 1)]


def split_bounds(m: int, split: int) -> list[int]:
    """``peel_decode_wide``'s blocks: checks ``round(i * m / split)``, with
    Python's round (half to even)."""
    return [round(i * m / split) for i in range(split + 1)]


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


def _check_impl(impl: str, gf_order: int, values: torch.Tensor) -> None:
    """JAX's two refusals, in its order (peel.py:179-187): an unknown
    ``impl``, then ``"matmul"`` on anything but binary scalar symbols."""
    if impl not in ("gather", "matmul", "worklist"):
        raise ValueError(f"unknown impl {impl!r}: expected gather | matmul | worklist")
    if impl == "matmul" and (gf_order != 2 or values.dim() == 3):
        raise ValueError("matmul impl supports binary scalar symbols only")


def peel_decode_jacobi(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    gf_order: int = 2,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    impl: str = "gather",
    worklist_size: int = 128,
    seq_blocks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's XLA ``peel_decode`` (peel.py:139-239): scalar (B, n) uint8
    symbols or wide (B, n, W) frames (int32 words for ``gf_order=2``, uint8
    bytes for 256).

    The sweep, as JAX picks it (peel.py:204-215): ``seq_blocks`` > 1 runs
    that many sequential check blocks (:func:`peel_step_seq_blocks`;
    ``seq_blocks == m`` is the MATLAB schedule, whatever ``impl`` says);
    otherwise ``impl="gather"`` runs the Jacobi sweep (:func:`jacobi_sweep`,
    which keeps the highest check's value where JAX's ORs them: the two
    agree on codewords), ``"matmul"`` the three products with H (binary
    scalar symbols only) and ``"worklist"`` at most ``worklist_size``
    degree-1 checks per frame and sweep. An unknown ``impl``, and
    ``"matmul"`` on other symbols, raise ValueError before any sweep.

    ``values`` may be the un-erased channel output: erased slots are zeroed
    first. Returns (values, erased, iters) in the input's form; erased slots
    left unsolved hold zero.
    """
    _check_impl(impl, gf_order, values)
    words, back = as_frames(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    words = words.masked_fill(erased[..., None], 0)
    if seq_blocks > 1:
        sweep = partial(block_sweep, arrays, gf_order=gf_order,
                        bounds=seq_block_bounds(arrays.m, seq_blocks))
    elif impl == "matmul":
        sweep = partial(matmul_sweep, arrays)
    elif impl == "worklist":
        sweep = partial(worklist_sweep, arrays, gf_order=gf_order, worklist=worklist_size)
    else:
        sweep = partial(jacobi_sweep, arrays, gf_order=gf_order)
    out, er, iters = batch_loop(sweep, words, erased, max_iters=max_iters, k_stop=k_stop)
    return back(out.contiguous()), er.contiguous(), iters


def peel_decode_wide(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    split: int = 1,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``peel_decode_wide`` (peel_wide.py:92-176) on wide (B, n, W)
    frames: ``split`` > 1 runs each sweep as that many sequential check
    blocks, cut at ``round(i * m / split)`` (not ``seq_blocks``' ceil
    partition). ``split=1`` is :func:`peel_decode_jacobi`, iteration counts
    included. Returns (values, erased, iters)."""
    if values.dim() != 3:
        raise ValueError(f"values must be wide (B, n, W) frames, got {tuple(values.shape)}")
    if split < 1:
        raise ValueError(f"split={split} must be >= 1")
    if split == 1:
        return peel_decode_jacobi(arrays, values, erased, gf_order=gf_order,
                                  max_iters=max_iters, early_stop_k=early_stop_k)
    words, back = as_frames(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    words = words.masked_fill(erased[..., None], 0)
    sweep = partial(block_sweep, arrays, gf_order=gf_order, bounds=split_bounds(arrays.m, split))
    out, er, iters = batch_loop(sweep, words, erased, max_iters=max_iters, k_stop=k_stop)
    return back(out.contiguous()), er.contiguous(), iters


def peel_decode_with_history(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    gf_order: int = 2,
    max_iters: int = 50,
    impl: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exactly ``max_iters`` sweeps, no stop (peel.py:436-462): returns
    (values, erased, hist), ``hist`` (B, max_iters) int32 each frame's
    erased count after each sweep, the reference's ``erasure_hist``
    (My_LDPC_Erasure_Decoder.m:16,45). ``impl="matmul"`` runs
    :func:`peel_step_matmul` (binary scalar symbols only, else ValueError);
    any other ``impl`` runs :func:`peel_step_gather`, as JAX does. Erased
    slots are zeroed first."""
    if impl == "matmul":
        _check_impl(impl, gf_order, values)
    words, back = as_frames(values, gf_order)
    _check(arrays, words, erased, max_iters, None)
    words = words.masked_fill(erased[..., None], 0)
    hist = []
    for _ in range(max_iters):
        if impl == "matmul":
            words, erased = matmul_sweep(arrays, words, erased)
        else:
            words, erased = gather_sweep(arrays, words, erased, gf_order)
        hist.append(erased.sum(dim=1, dtype=torch.int32))
    hist = (torch.stack(hist, dim=1) if hist else
            torch.zeros((erased.shape[0], 0), dtype=torch.int32, device=erased.device))
    return back(words.contiguous()), erased.contiguous(), hist


def _step(values: torch.Tensor, erased: torch.Tensor, gf_order: int, sweep: Sweep):
    words, back = as_frames(values, gf_order)
    if erased.dtype != torch.bool or erased.shape != words.shape[:2]:
        raise ValueError(f"erased must be {tuple(words.shape[:2])} bool, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    out, er = sweep(words, erased)
    return back(out.contiguous()), er.contiguous()


def peel_step_gather(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, gf_order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep as JAX's ``peel_step_gather`` (peel.py:65-113), on
    any input: an erased symbol takes the OR of its degree-1 checks'
    values. Erased slots are read as given (JAX's contract: zero)."""
    return _step(values, erased, gf_order, partial(gather_sweep, arrays, gf_order=gf_order))


def peel_step_matmul(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep as JAX's ``peel_step_matmul`` (peel.py:116-136): binary
    scalar (B, n) uint8 symbols, three products with H."""
    _check_impl("matmul", 2, values)
    return _step(values, erased, 2, partial(matmul_sweep, arrays))


def peel_step_seq_blocks(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, gf_order: int,
    seq_blocks: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep as ``seq_blocks`` sequential check blocks of
    ``ceil(m / seq_blocks)`` checks (peel.py:242-306): Jacobi within a
    block, Gauss-Seidel between blocks."""
    bounds = seq_block_bounds(arrays.m, seq_blocks)
    return _step(values, erased, gf_order,
                 partial(block_sweep, arrays, gf_order=gf_order, bounds=bounds))


def peel_step_worklist(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, gf_order: int,
    worklist: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep over at most ``worklist`` degree-1 checks per frame, the
    first in check order (peel.py:309-376)."""
    return _step(values, erased, gf_order,
                 partial(worklist_sweep, arrays, gf_order=gf_order, worklist=worklist))


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


def _check_mask(arrays: CodeArrays, erased: torch.Tensor, max_iters: int,
                early_stop_k: int | None) -> int:
    n = erased.shape[-1]
    if (erased.dtype != torch.bool or erased.dim() != 2 or n != arrays.n
            or erased.device != arrays.device):
        raise ValueError(f"erased must be (B, {arrays.n}) bool on {arrays.device}, got "
                         f"{tuple(erased.shape)} {erased.dtype} on {erased.device}")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} must be >= 0")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    if not 0 <= k_stop <= n:
        raise ValueError(f"early_stop_k={early_stop_k} outside 0..{n}")
    return k_stop


def peel_decode_mask_reference(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`peel_decode_mask` (peel.py:382-433): sweeps
    of :func:`mask_sweep` inside :func:`batch_loop`, two host reads a
    sweep. Returns (residual mask, iters)."""
    k_stop = _check_mask(arrays, erased, max_iters, early_stop_k)
    _, er, iters = batch_loop(
        lambda v, e: (v, mask_sweep(arrays, e)), erased, erased,
        max_iters=max_iters, k_stop=k_stop,
    )
    return er, iters


def _mask_smem(arrays: CodeArrays, nwin: int = 0) -> int:
    """Shared memory a block of ``csrc/peel_mask.cu`` takes: the group's
    words and the checks' words, each with a zero pad, then the Vlist and
    the Clist as uint16; counting, launch 1 adds ``nwin`` RS windows' counts
    of 32 frames."""
    n, m, dmax = arrays.n, arrays.m, arrays.dmax
    cmax = arrays.clist_idx.shape[1]
    r16 = _build.round16
    return (r16(4 * (n + 1)) + r16(4 * (m + 1)) + r16(2 * m * dmax) + r16(2 * n * cmax)
            + r16(4 * 32 * nwin))


def rs_windows(n: int, rs_n: int) -> int:
    """RS windows a frame of ``n`` symbols is scored in: ``n / rs_n`` where
    ``rs_n`` divides n, else none (``sim/stats.py::batch_stats``' rule)."""
    return n // rs_n if rs_n > 0 and n % rs_n == 0 else 0


def mask_kernel_fits(arrays: CodeArrays, rs_n: int = 0) -> bool:
    """Whether ``csrc/peel_mask.cu`` takes the code: rows of 32-bit words
    (n a multiple of 4), uint16 tables (n, m < 65535), and its shared memory,
    with the RS windows of ``rs_n`` symbols that counting keeps."""
    n, m = arrays.n, arrays.m
    return (n % 4 == 0 and n < 65535 and m < 65535
            and _mask_smem(arrays, rs_windows(n, rs_n)) <= _build.SMEM_LIMIT)


def _launch_mask(arrays: CodeArrays, erased: torch.Tensor, k_stop: int, max_iters: int, *,
                 er_out: torch.Tensor | None = None, iters: torch.Tensor | None = None,
                 stats: torch.Tensor | None = None, k_count: int = 0, rs_n: int = 0,
                 rs_k: int = 0) -> None:
    """Both launches of ``csrc/peel_mask.cu`` on CUDA ``erased``: the
    residual into ``er_out`` and ``iters``, or, given ``stats``, the
    counters added into it. Counted on ``peel_decode_mask.launches``."""
    b, n = erased.shape
    m, dev = arrays.m, erased.device
    nwin = 0 if stats is None else rs_windows(n, rs_n)
    if not mask_kernel_fits(arrays, rs_n if nwin else 0):
        raise ValueError(f"the mask kernel reads rows as 32-bit words and stages the Vlist and "
                         f"the Clist as uint16 in shared memory: n={n} (a multiple of 4), m={m} "
                         f"(< 65535 each), {_mask_smem(arrays, nwin)} bytes "
                         f"(<= {_build.SMEM_LIMIT})")
    if b == 0:
        return
    erased = erased.contiguous()
    if erased.data_ptr() % 4:
        erased = erased.clone()
    # Each group's words, then max d, max c and T.
    scratch = torch.empty((-(-b // 32) * n + 3,), dtype=torch.int32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _build.library().ldpc_peel_mask_launch(
            erased.data_ptr(), arrays.vlist_idx.data_ptr(), arrays.vlist_len.data_ptr(),
            arrays.clist_idx.data_ptr(), arrays.clist_len.data_ptr(), scratch.data_ptr(),
            ptr(er_out), ptr(iters), b, n, m, arrays.dmax, arrays.clist_idx.shape[1], k_stop,
            max_iters, ptr(stats), k_count, rs_n, rs_k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "ldpc_peel_mask_launch")
    peel_decode_mask.launches += 1
    if profiling.enabled():
        profiling.count("peel.mask_kernel_frames", b)
        profiling.count("peel.mask_sweeps", scratch[-1])
        if stats is not None:
            profiling.count("peel.mask_stats_frames", b)


def peel_decode_mask(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pattern-only peeling (peel.py:382-433): the mask evolves as in the
    value decode, which it does not depend on. Returns (residual mask (B,
    n) bool, iters (B,) int32), with the JAX loop's batch-wide stop.

    CPU tensors take :func:`peel_decode_mask_reference`; CUDA tensors launch
    ``csrc/peel_mask.cu`` (or raise), which decides the stop on the card:
    no host read. ``peel_decode_mask.launches`` counts the calls that
    launch it (its two kernels as one), :func:`peel_decode_mask_stats`'
    included."""
    k_stop = _check_mask(arrays, erased, max_iters, early_stop_k)
    if erased.device.type == "cpu":
        return peel_decode_mask_reference(arrays, erased, max_iters=max_iters,
                                          early_stop_k=early_stop_k)
    if erased.device.type != "cuda":
        raise ValueError(f"unsupported device {erased.device}")
    b, n = erased.shape
    er_out = torch.empty((b, n), dtype=torch.bool, device=erased.device)
    iters = torch.empty((b,), dtype=torch.int32, device=erased.device)
    _launch_mask(arrays, erased, k_stop, max_iters, er_out=er_out, iters=iters)
    return er_out, iters


peel_decode_mask.launches = 0


def peel_decode_mask_stats(
    arrays: CodeArrays,
    erased: torch.Tensor,
    stats: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    k_count: int,
    rs_n: int = 0,
    rs_k: int = 0,
) -> None:
    """:func:`peel_decode_mask` on CUDA ``erased`` whose outputs only feed
    the FER simulation's counters: adds the batch's ``SimStats`` into
    ``stats`` ((9 + max_iters,) int64 on the card, ``SimStats``' order, the
    histogram's bins last), counted inside ``csrc/peel_mask.cu``; the
    residual and the iteration counts are not written. A block error is an
    erasure left among the first ``k_count`` symbols; the RS windows are
    those of ``rs_n`` symbols (:func:`rs_windows`), failing past ``rs_n -
    rs_k`` erasures. The counts are ``sim/stats.py::batch_stats`` of
    :func:`peel_decode_mask`'s outputs, its plain version. No host read;
    counted on ``peel_decode_mask.launches``, on
    ``peel_decode_mask_stats.launches`` and, while profiling records,
    ``peel.mask_stats_frames``."""
    k_stop = _check_mask(arrays, erased, max_iters, early_stop_k)
    n = erased.shape[1]
    if (stats.dtype != torch.int64 or stats.shape != (9 + max_iters,)
            or stats.device != erased.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous ({9 + max_iters},) int64 on {erased.device}, "
                         f"got {tuple(stats.shape)} {stats.dtype} on {stats.device}")
    if not 0 <= k_count <= n:
        raise ValueError(f"k_count={k_count} outside 0..{n}")
    if erased.device.type != "cuda":
        raise ValueError(f"the counting launch runs on the card, not {erased.device}: on the "
                         f"CPU count batch_stats over peel_decode_mask")
    _launch_mask(arrays, erased, k_stop, max_iters, stats=stats, k_count=k_count, rs_n=rs_n,
                 rs_k=rs_k)
    if erased.shape[0]:
        peel_decode_mask_stats.launches += 1


peel_decode_mask_stats.launches = 0
