"""The binary GE's packed ``[A | T]`` coefficient cube, built from the
erasure mask in one kernel.

:func:`f2_cube` writes what ``ops/ge.py::erased_indices`` and
``coefficient_cube`` give together, bit for bit: the erased positions of
each frame in the stable argsort's order (pad slots included), the full
erasure count, and the packed cube. For CUDA tensors it launches
``csrc/cube.cu`` (one block per frame: a slot table of the erased symbols
in shared memory, then a warp per row of H over its Vlist neighbours);
:func:`.ge.ge_solve_packed` takes it there. The kernel replaces no Pallas
kernel: the JAX package builds the cube in XLA (ge.py:234-251), as the
port's plain path does in PyTorch. CPU tensors take
:func:`f2_cube_reference`, the kernel's order in plain PyTorch.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.utils import profiling

# The slot table holds int16 positions.
MAX_N = 32767


def _check(arrays: CodeArrays, erased: torch.Tensor, emax: int) -> None:
    if erased.dtype != torch.bool or erased.dim() != 2 or erased.shape[1] != arrays.n:
        raise ValueError(f"erased must be (B, {arrays.n}) bool, got "
                         f"{tuple(erased.shape)} {erased.dtype}")
    if emax < 0:
        raise ValueError(f"emax must be >= 0, got {emax}")
    if arrays.n > MAX_N:
        raise ValueError(f"n={arrays.n}: the kernel's slot table takes n <= {MAX_N}")
    if erased.device != arrays.device:
        raise ValueError(f"erased on {erased.device}, code tables on {arrays.device}")


def f2_cube_reference(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in its order: each symbol's
    position (its rank among the erased symbols, or the frame's erasures
    plus its rank among the others), the slot table (the position of each
    erased symbol below ``emax``, -1 elsewhere), then each row's A words
    from the slots of its Vlist neighbours and its T word. Returns (er_idx
    (B, emax) int32, nreal (B,) int32, cube (B, m, wa + wt) int32)."""
    _check(arrays, erased, emax)
    b, n = erased.shape
    emax = min(emax, n)
    m, dev = arrays.m, erased.device
    wa, wt = -(-emax // 32), -(-m // 32)
    e = erased.to(torch.int32)
    before = e.cumsum(dim=1, dtype=torch.int32) - e  # erased symbols before each
    nreal = e.sum(dim=1, dtype=torch.int32)
    syms = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    pos = torch.where(erased, before, nreal[:, None] + syms - before)
    slot = torch.where(erased & (pos < emax), pos, -1)
    er_idx = torch.zeros((b, emax + 1), dtype=torch.int32, device=dev)
    # Positions past emax land in column emax, which is dropped.
    er_idx.scatter_(1, pos.clamp(max=emax).long(), syms.contiguous())
    deg = torch.arange(arrays.dmax, device=dev)[None, :] < arrays.vlist_len[:, None]
    nbr = torch.where(deg, arrays.vlist_idx, n).long()  # (m, dmax), pad = n
    slot_pad = torch.cat([slot, slot.new_full((b, 1), -1)], dim=1)  # column n: no slot
    a = torch.zeros((b, m, wa + 1), dtype=torch.int32, device=dev)  # word wa: discards
    for t in range(arrays.dmax):
        p = slot_pad[:, nbr[:, t]]  # (B, m)
        word = torch.where(p >= 0, p >> 5, wa).long()
        bit = torch.where(p >= 0, torch.ones_like(p) << (p & 31), 0)
        a |= torch.zeros_like(a).scatter_(2, word[:, :, None], bit[:, :, None])
    rows = torch.arange(m, device=dev)
    t_words = torch.zeros((m, wt), dtype=torch.int32, device=dev)
    t_words[rows, rows >> 5] = torch.ones_like(rows, dtype=torch.int32) << (rows & 31).int()
    cube = torch.cat([a[:, :, :wa], t_words.expand(b, m, wt)], dim=2).contiguous()
    return er_idx[:, :emax].contiguous(), nreal, cube


def f2_cube(
    arrays: CodeArrays, erased: torch.Tensor, *, emax: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GE's index list, erasure counts and packed ``[A | T]`` cube.

    Args:
      arrays: the binary code's tables (``vlist_idx``, ``vlist_len``).
      erased: (B, n) bool residual masks.
      emax: the column bucket (clamped to n).

    Returns (er_idx (B, emax) int32, nreal (B,) int32, cube (B, m, wa + wt)
    int32), equal to ``erased_indices``' er_idx and nreal and
    ``coefficient_cube``'s cube (:mod:`.ge`). CPU tensors take
    :func:`f2_cube_reference`; CUDA tensors launch the kernel (or raise),
    none for B = 0. ``f2_cube.launches`` counts kernel launches."""
    _check(arrays, erased, emax)
    if erased.device.type == "cpu":
        return f2_cube_reference(arrays, erased, emax=emax)
    if erased.device.type != "cuda":
        raise ValueError(f"unsupported device {erased.device}")
    b, n = erased.shape
    m, dev = arrays.m, erased.device
    emax = min(emax, n)
    profiling.count("ge.cube_kernel_frames", b)
    erased = erased.contiguous()
    er_idx = torch.empty((b, emax), dtype=torch.int32, device=dev)
    nreal = torch.empty((b,), dtype=torch.int32, device=dev)
    cube = torch.empty((b, m, -(-emax // 32) + -(-m // 32)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().ldpc_cube_launch(
            erased.data_ptr(), arrays.vlist_idx.data_ptr(), arrays.vlist_len.data_ptr(),
            er_idx.data_ptr(), nreal.data_ptr(), cube.data_ptr(), b, n, m, arrays.dmax, emax,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "ldpc_cube_launch")
    if b:
        f2_cube.launches += 1
    return er_idx, nreal, cube


f2_cube.launches = 0
