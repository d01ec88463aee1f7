"""The pattern-only GF(2) rank check of the FER simulation's hybrid.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_ge.py::
ge_rank_pallas`` (:84-132), the drop-in for ``ops/ge.py::
ge_rank_check(gf_order=2)``: would the Gauss-Jordan on a frame's residual
succeed? A frame fails when it has more than ``emax`` erasures, or when the
erased columns of H are linearly dependent. That is the pivot loop's
failure flag: the real columns come before the pad slots, whose identity
rows only pivot pad columns, so a real column fails to find a pivot exactly
when it lies in the span of the real columns before it.

:func:`f2_rank_check` launches ``csrc/rank.cu`` for CUDA tensors (one block
per frame, the erased columns built bit-packed from the Clist) by the first
of :data:`ROUTES` that fits: "registers" (a thread per row, m <= 1024 and
emax <= 512, the row's words in registers, one barrier per column step),
"smem" (256 threads, a row scan and two barriers per column step, the
matrix in shared memory) or "device" (the same column step on a matrix in
device memory). All pick the first candidate row as the pivot, the order
of :func:`f2_rank_check_reference`.
CPU tensors take the reference.
``ops/ge.py::ge_rank_check`` sends binary CUDA tensors here.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, pack_bits


def _check(arrays: CodeArrays, erased: torch.Tensor, emax: int) -> None:
    if erased.dtype != torch.bool or erased.dim() != 2 or erased.shape[1] != arrays.n:
        raise ValueError(f"erased must be (B, {arrays.n}) bool, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    if emax < 0:
        raise ValueError(f"emax must be >= 0, got {emax}")
    if erased.device != arrays.device:
        raise ValueError(f"erased on {erased.device}, code tables on {arrays.device}")


def erased_columns(arrays: CodeArrays, erased: torch.Tensor, emax: int) -> torch.Tensor:
    """The erased columns of H, bit-packed: (B, m, ceil(emax/32)) int32,
    column j (bit j & 31 of word j >> 5) = the frame's j-th erased symbol's
    checks, for j < min(nreal, emax); later columns are zero. Built from
    the Clist, as the kernel builds it."""
    b, n = erased.shape
    m = arrays.m
    col = erased.cumsum(dim=1) - 1  # each erased symbol's column
    frames, syms = torch.nonzero(erased & (col < emax), as_tuple=True)
    checks = arrays.clist_idx[syms].long()  # (E, cmax), pad = m
    real = checks < m
    a = torch.zeros((b, m + 1, max(emax, 1)), dtype=torch.uint8, device=erased.device)
    a[frames[:, None].expand_as(checks), torch.where(real, checks, m),
      col[frames, syms][:, None].expand_as(checks)] = 1
    return pack_bits(a[:, :m, :emax])


def f2_rank_check_reference(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: forward elimination without
    swaps of the packed erased columns, column by column up to the batch's
    widest residual; a frame fails at the first real column with no unused
    pivot row, or when it has more than ``emax`` erasures. Returns failed
    (B,) bool."""
    _check(arrays, erased, emax)
    b, n = erased.shape
    emax = min(emax, n)
    nreal = erased.sum(dim=1)
    failed = nreal > emax
    a = erased_columns(arrays, erased, emax)  # (B, m, wa)
    m = a.shape[1]
    used = torch.zeros((b, m), dtype=torch.bool, device=erased.device)
    frames = torch.arange(b, device=erased.device)
    ub = min(int(nreal.max()), emax) if b else 0
    for col in range(ub):
        colv = ((a[:, :, col >> 5] >> (col & 31)) & 1).bool() & ~used  # (B, m)
        has = colv.any(dim=1)
        failed |= ~has & (col < nreal)
        piv = colv.to(torch.uint8).argmax(dim=1)  # first candidate row
        is_piv = torch.zeros_like(used)
        is_piv[frames, piv] = has
        used |= is_piv
        elim = colv & ~is_piv & has[:, None]
        a ^= torch.where(elim[:, :, None], a[frames, piv][:, None, :], 0)
    return failed


ROUTES = ("registers", "smem", "device")


def route_fits(route: str, n: int, m: int, emax: int) -> bool:
    """Whether the kernel's ``route`` takes a frame of n symbols, m rows
    and ``emax`` columns on the current CUDA device: "registers" needs m <=
    1024 and emax <= 512; "smem" needs the m x ceil(emax/32)-word matrix
    within the shared memory a block may opt in to; "device" needs only the
    frame's bitmasks (n + 2m bits) within 48 KB of shared memory."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return bool(_build.library().ldpc_rank_fits(ROUTES.index(route), n, m, emax))


def kernel_route(n: int, m: int, emax: int) -> str:
    """The first of :data:`ROUTES` that fits (the fastest); raises where
    none does."""
    for route in ROUTES:
        if route_fits(route, n, m, emax):
            return route
    raise ValueError(f"no route of the rank kernel takes n={n}, m={m}, emax={emax}")


def launch_kernel(arrays: CodeArrays, erased: torch.Tensor, emax: int, route: str):
    """Launch the kernel by ``route``; :func:`f2_rank_check` picks the
    route by size, the card tests force each. Raises where the route does
    not fit the shapes."""
    b, n = erased.shape
    if not route_fits(route, n, arrays.m, emax):
        raise ValueError(f"the rank kernel's {route!r} route does not take n={n}, "
                         f"m={arrays.m}, emax={emax} on this device")
    failed = torch.empty((b,), dtype=torch.bool, device=erased.device)
    words = 0
    if route == "device":
        words = b * _build.library().ldpc_rank_scratch_words(arrays.m, emax)
    scratch = torch.empty((max(words, 1),), dtype=torch.int32, device=erased.device)
    rc = _build.library().ldpc_rank_launch(
        erased.data_ptr(), arrays.clist_idx.data_ptr(), arrays.clist_len.data_ptr(),
        scratch.data_ptr(), failed.data_ptr(), b, n, arrays.m, arrays.clist_idx.shape[1], emax,
        ROUTES.index(route), torch.cuda.current_stream(erased.device).cuda_stream,
    )
    _build.check(rc, "ldpc_rank_launch")
    f2_rank_check.launches += 1
    return failed


def f2_rank_check(arrays: CodeArrays, erased: torch.Tensor, *, emax: int) -> torch.Tensor:
    """GF(2) solvability of each frame's erasure pattern.

    Args:
      arrays: the binary code's tables (``clist_idx``, ``clist_len``).
      erased: (B, n) bool residual masks.
      emax: the column bucket (clamped to n); a frame with more erasures
        fails (overflow).

    Returns failed (B,) bool, equal to ``ge_rank_check(gf_order=2)``'s.
    CPU tensors take :func:`f2_rank_check_reference`; CUDA tensors launch
    the kernel (or raise) by the first of :data:`ROUTES` that fits.
    ``f2_rank_check.launches`` counts kernel launches.
    """
    _check(arrays, erased, emax)
    if erased.device.type == "cpu":
        return f2_rank_check_reference(arrays, erased, emax=emax)
    if erased.device.type != "cuda":
        raise ValueError(f"unsupported device {erased.device}")
    emax = min(emax, arrays.n)
    erased = erased.contiguous()
    with torch.cuda.device(erased.device):
        return launch_kernel(arrays, erased, emax, kernel_route(arrays.n, arrays.m, emax))


f2_rank_check.launches = 0
