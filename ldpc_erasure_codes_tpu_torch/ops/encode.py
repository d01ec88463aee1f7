"""Systematic triangular encode of packed words: (B, k, W) -> (B, n, W).

Counterpart of ``ldpc_erasure_codes_tpu/ops/encode.py::encode_packed``
(:57-137) and of the TPU kernel ``ops/pallas_encode.py::encode_packed_vmem``
(:223-379), which compute the same codewords. :func:`encode_packed` launches
the CUDA kernel ``csrc/encode.cu`` for CUDA tensors and runs
:func:`encode_packed_reference` for CPU tensors. Binary codes only.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays


def _check(arrays: CodeArrays, source: torch.Tensor, gf_order: int) -> None:
    if gf_order != 2:
        raise NotImplementedError(f"gf_order={gf_order}: only binary codes are ported")
    if source.dtype != torch.int32:
        raise TypeError(f"source must be torch.int32 words, got {source.dtype}")
    if source.dim() != 3 or source.shape[2] < 1:
        raise ValueError(f"source must be (B, k, W) with W >= 1, got {tuple(source.shape)}")
    if source.device != arrays.device:
        raise ValueError(f"source on {source.device}, code tables on {arrays.device}")
    if not source.is_contiguous():
        raise ValueError("source must be contiguous")


def encode_packed_reference(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch encode, as encode.py:111-137: a gather-XOR over each
    parity row's source neighbours, then the back-substitution over parity
    rows in order."""
    _check(arrays, source, 2)
    b, k, w = source.shape
    m = arrays.m
    src_p = torch.cat([source, source.new_zeros(b, 1, w)], dim=1)  # pad col k reads zero
    src_idx = arrays.enc_src_idx.long()
    t = source.new_zeros(b, m, w)
    for s in range(src_idx.shape[1]):
        t ^= src_p[:, src_idx[:, s], :]
    parity = source.new_zeros(b, m, w)
    for i, row in enumerate(arrays.enc_par_idx.tolist()):
        acc = t[:, i]
        for p in row:
            if p < m:
                acc = acc ^ parity[:, p]
        parity[:, i] = acc
    return torch.cat([source, parity], dim=1)


def encode_packed(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Systematic encode of ``source`` (B, k, W) int32 words -> (B, n, W).

    CPU tensors take :func:`encode_packed_reference`; CUDA tensors launch
    the kernel (or raise). ``encode_packed.launches`` counts kernel launches.
    """
    _check(arrays, source, gf_order)
    if source.device.type == "cpu":
        return encode_packed_reference(arrays, source)
    if source.device.type != "cuda":
        raise ValueError(f"unsupported device {source.device}")
    b, k, w = source.shape
    m, pmax = arrays.enc_par_idx.shape
    out = torch.empty((b, k + m, w), dtype=torch.int32, device=source.device)
    rc = _build.library().ldpc_encode_launch(
        source.data_ptr(), arrays.enc_src_idx.data_ptr(), arrays.enc_par_idx.data_ptr(),
        out.data_ptr(), b, k, m, w, arrays.enc_src_idx.shape[1], pmax,
        torch.cuda.current_stream(source.device).cuda_stream,
    )
    _build.check(rc, "ldpc_encode_launch")
    encode_packed.launches += 1
    return out


encode_packed.launches = 0
