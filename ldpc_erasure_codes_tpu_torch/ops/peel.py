"""Sequential (Gauss-Seidel) peeling decode of packed words.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_peel.py::
peel_decode_vmem`` (:1281-1786) with its production schedules "unrolled"
(+ fence gate) and "seq", which compute the same function. The TPU's
tile-major layout exists only for its VMEM; the port keeps the plain
(B, n, W) layout end to end. :func:`peel_decode` launches the CUDA kernel
``csrc/peel.cu`` for CUDA tensors and runs :func:`peel_decode_reference`
for CPU tensors.

Stopping is per frame: a frame stops after the first sweep that leaves its
first ``early_stop_k`` symbols known, or that changes nothing. The TPU
kernel stops per 32-frame tile, so with ``early_stop_k`` the two agree on
iteration counts, on the first-k mask and on every resolved value, and the
parity-region residual may differ (pallas_peel.py:1314-1320). The kernel
and :func:`peel_decode_reference` agree bit for bit on every output.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays


def _check(arrays: CodeArrays, values, erased, max_iters, early_stop_k) -> int:
    """Validate the inputs; returns k_stop."""
    if values.dtype != torch.int32:
        raise TypeError(f"values must be torch.int32 words, got {values.dtype}")
    if erased.dtype != torch.bool:
        raise TypeError(f"erased must be torch.bool, got {erased.dtype}")
    if values.dim() != 3 or values.shape[2] < 1:
        raise ValueError(f"values must be (B, n, W) with W >= 1, got {tuple(values.shape)}")
    b, n, _ = values.shape
    if erased.shape != (b, n):
        raise ValueError(f"erased shape {tuple(erased.shape)} != {(b, n)}")
    if n < arrays.min_n:
        raise ValueError(f"n={n} is shorter than the code's columns ({arrays.min_n})")
    if not (values.device == erased.device == arrays.device):
        raise ValueError(
            f"values on {values.device}, erased on {erased.device}, "
            f"code tables on {arrays.device}"
        )
    if not (values.is_contiguous() and erased.is_contiguous()):
        raise ValueError("values and erased must be contiguous")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} must be >= 0")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    if not 0 <= k_stop <= n:
        raise ValueError(f"early_stop_k={early_stop_k} outside 0..{n}")
    return k_stop


def peel_decode_reference(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode: a Python loop over sweeps and checks,
    vectorised over frames and words, with the kernel's per-frame stop."""
    k_stop = _check(arrays, values, erased, max_iters, early_stop_k)
    b = values.shape[0]
    dev = values.device
    er = erased.clone()
    v = values.masked_fill(er[:, :, None], 0)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    checks = [
        torch.tensor(row[:d], dtype=torch.long, device=dev)
        for row, d in zip(arrays.vlist_idx.tolist(), arrays.vlist_len.tolist())
    ]
    for it in range(max_iters):
        changed = torch.zeros(b, dtype=torch.bool, device=dev)
        for nb in checks:
            e_nb = er[:, nb]  # (B, d)
            deg1 = (e_nb.sum(dim=1) == 1) & active
            if not bool(deg1.any()):
                continue
            f = deg1.nonzero().squeeze(1)
            rows = v[f[:, None], nb[None, :]]  # (F, d, W); the erased slot holds zero
            acc = rows[:, 0]
            for j in range(1, nb.numel()):
                acc = acc ^ rows[:, j]
            slot = nb[e_nb[f].to(torch.int8).argmax(dim=1)]
            v[f, slot] = acc
            er[f, slot] = False
            changed[f] = True
        fin = active & (er[:, :k_stop].sum(dim=1) == 0)
        iters[fin] = it + 1
        active = active & ~fin & changed
        if not bool(active.any()):
            break
    return v, er, iters


def peel_decode(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peeling decode. Returns (values (B, n, W) int32, erased (B, n) bool,
    iters (B,) int32).

    ``values`` may be the un-erased channel output: the masking is fused
    into the decode, and erased output slots hold zero. CPU tensors take
    :func:`peel_decode_reference`; CUDA tensors launch the kernel (or
    raise). ``peel_decode.launches`` counts kernel launches.
    """
    k_stop = _check(arrays, values, erased, max_iters, early_stop_k)
    if values.device.type == "cpu":
        return peel_decode_reference(
            arrays, values, erased, max_iters=max_iters, early_stop_k=early_stop_k
        )
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    b, n, w = values.shape
    out = torch.empty_like(values)
    er_out = torch.empty((b, n), dtype=torch.bool, device=values.device)
    iters = torch.empty((b,), dtype=torch.int32, device=values.device)
    rc = _build.library().ldpc_peel_launch(
        values.data_ptr(), erased.data_ptr(), arrays.vlist_idx.data_ptr(),
        arrays.vlist_len.data_ptr(), out.data_ptr(), er_out.data_ptr(), iters.data_ptr(),
        b, n, arrays.m, arrays.dmax, w, k_stop, max_iters,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(rc, "ldpc_peel_launch")
    peel_decode.launches += 1
    return out, er_out, iters


peel_decode.launches = 0
