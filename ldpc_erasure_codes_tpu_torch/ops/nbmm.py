"""GF(2) products of packed 0/1 matrices with word rows (the binary part of
``ldpc_erasure_codes_tpu/ops/pallas_nbmm.py``).

Counterparts of the TPU kernels ``f2_matvec_wide`` (:342-404),
``f2_matmul_batched`` (:407-462) and ``f2_apply_scatter`` (:465-553), which
share ``_f2_matmul_body`` (:314-338). The TPU kernels take an unpacked int8
0/1 matrix for the MXU and byte-viewed values; the port keeps the matrices
packed, (E, ceil(K/32)) int32 words with bit ``j`` of a row in bit
``j & 31`` of word ``j >> 5`` (H as ``CodeArrays.h_words``, the transforms
straight from the eliminated cube), and the values as (B, K, W) int32 words.
A GF(2) product acts on each bit position alone, so the bits equal the
byte-plane MXU form's. All three launch one CUDA body, ``csrc/f2mm.cu``,
for CUDA tensors and run the plain versions for CPU tensors. Bits of a
matrix row at or past K are ignored.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import pack_bits, unpack_bits

# Words per chunk of the plain product: bounds its unpacked float operand
# to (B, K, 32 * _PLAIN_WORDS), as ge.py:417 bounds its int8 temp.
_PLAIN_WORDS = 16


def _check(rhs: torch.Tensor, mat: torch.Tensor, per_frame: bool) -> None:
    if rhs.dtype != torch.int32 or mat.dtype != torch.int32:
        raise TypeError(f"rhs and matrix must be torch.int32, got {rhs.dtype}, {mat.dtype}")
    if rhs.dim() != 3 or rhs.shape[2] < 1:
        raise ValueError(f"rhs must be (B, K, W) with W >= 1, got {tuple(rhs.shape)}")
    b, k, _ = rhs.shape
    kw = -(-k // 32)
    if mat.dim() != (3 if per_frame else 2):
        raise ValueError(f"matrix must be {'(B, E, KW)' if per_frame else '(m, KW)'}, "
                         f"got {tuple(mat.shape)}")
    want = (b, mat.shape[1], kw) if per_frame else (mat.shape[0], kw)
    if tuple(mat.shape) != want:
        raise ValueError(f"matrix shape {tuple(mat.shape)} != {want} for rhs {tuple(rhs.shape)}")
    if rhs.device != mat.device:
        raise ValueError(f"rhs on {rhs.device}, matrix on {mat.device}")
    if not (rhs.is_contiguous() and mat.is_contiguous()):
        raise ValueError("rhs and matrix must be contiguous")


def _product_reference(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x[b] = M_b . rhs[b] over GF(2) as a bit-plane product mod 2, chunked
    over W (ge.py:416-429). ``mat`` is (B or 1, E, KW); counts stay below
    2^24, so float32 sums are exact."""
    b, k, w = rhs.shape
    m01 = unpack_bits(mat)[..., :k].float()  # (B|1, E, K)
    chunks = []
    for off in range(0, w, _PLAIN_WORDS):
        wc = min(_PLAIN_WORDS, w - off)
        bits = unpack_bits(rhs[:, :, off : off + wc]).float()  # (B, K, 32wc)
        par = torch.matmul(m01, bits).to(torch.int32) & 1  # (B, E, 32wc)
        chunks.append(pack_bits(par))
    return torch.cat(chunks, dim=2)


def f2_matvec_wide_reference(values: torch.Tensor, h_words: torch.Tensor) -> torch.Tensor:
    _check(values, h_words, per_frame=False)
    return _product_reference(h_words[None], values)


def f2_matmul_batched_reference(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    _check(rhs, t_words, per_frame=True)
    return _product_reference(t_words, rhs)


def f2_apply_scatter_reference(
    values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    _check_apply(values, rhs, t_words, idx)
    x = _product_reference(t_words, rhs)
    out = values.clone()
    keep = (idx >= 0) & (idx < values.shape[1])
    frames = torch.arange(values.shape[0], device=values.device)[:, None].expand_as(idx)
    f, t = frames[keep], idx[keep].long()
    out[f, t] ^= x[keep]
    return out


def _check_apply(values, rhs, t_words, idx) -> None:
    _check(rhs, t_words, per_frame=True)
    b, _, w = rhs.shape
    if values.dtype != torch.int32 or values.dim() != 3 or values.shape[::2] != (b, w):
        raise ValueError(f"values {tuple(values.shape)} {values.dtype} vs rhs {tuple(rhs.shape)}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, t_words.shape[1]):
        raise ValueError(f"idx must be ({b}, {t_words.shape[1]}) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if not (values.device == idx.device == rhs.device):
        raise ValueError("values, idx and rhs must be on one device")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("values and idx must be contiguous")


def _stream(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def f2_matvec_wide(values: torch.Tensor, h_words: torch.Tensor) -> torch.Tensor:
    """rhs[b] = H . values[b] over GF(2): (B, n, W) int32 -> (B, m, W).

    ``h_words`` is (m, ceil(n/32)), ``CodeArrays.h_words``. Erased slots of
    ``values`` hold zero, so this is the syndrome of the known symbols.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise). ``f2_matvec_wide.launches`` counts kernel launches.
    """
    _check(values, h_words, per_frame=False)
    if values.device.type == "cpu":
        return f2_matvec_wide_reference(values, h_words)
    b, n, w = values.shape
    m, kw = h_words.shape
    out = torch.empty((b, m, w), dtype=torch.int32, device=values.device)
    rc = _build.library().ldpc_f2_matvec_launch(
        values.data_ptr(), h_words.data_ptr(), out.data_ptr(), b, n, kw, m, w, _stream(values)
    )
    _build.check(rc, "ldpc_f2_matvec_launch")
    f2_matvec_wide.launches += 1
    return out


def f2_matmul_batched(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    """x[b] = T_b . rhs[b] over GF(2): rhs (B, K, W), T (B, E, ceil(K/32))
    -> (B, E, W) int32, the solved rows without placement.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise). ``f2_matmul_batched.launches`` counts kernel launches.
    """
    _check(rhs, t_words, per_frame=True)
    if rhs.device.type == "cpu":
        return f2_matmul_batched_reference(rhs, t_words)
    b, k, w = rhs.shape
    _, e, kw = t_words.shape
    out = torch.empty((b, e, w), dtype=torch.int32, device=rhs.device)
    rc = _build.library().ldpc_f2_matmul_launch(
        rhs.data_ptr(), t_words.data_ptr(), out.data_ptr(), b, k, kw, e, w, _stream(rhs)
    )
    _build.check(rc, "ldpc_f2_matmul_launch")
    f2_matmul_batched.launches += 1
    return out


def f2_apply_scatter(
    values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``values`` with row e of T_b . rhs[b] XORed into symbol idx[b, e]:
    the solved rows placed in the erased slots (which hold zero).

    values (B, n, W), rhs (B, K, W), T (B, E, ceil(K/32)) int32, idx (B, E)
    int32. Targets outside [0, n) are dropped (the TPU kernel's dump rows,
    cut off at ge.py:412-414); targets in range must be distinct within a
    frame. Returns a new (B, n, W) tensor. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise).
    ``f2_apply_scatter.launches`` counts kernel launches.
    """
    _check_apply(values, rhs, t_words, idx)
    if values.device.type == "cpu":
        return f2_apply_scatter_reference(values, rhs, t_words, idx)
    b, k, w = rhs.shape
    _, e, kw = t_words.shape
    stream = _stream(values)
    out = values.clone()
    rc = _build.library().ldpc_f2_apply_launch(
        rhs.data_ptr(), t_words.data_ptr(), idx.data_ptr(), out.data_ptr(), b, k, kw, e, w,
        values.shape[1], stream,
    )
    _build.check(rc, "ldpc_f2_apply_launch")
    f2_apply_scatter.launches += 1
    return out


f2_matvec_wide.launches = 0
f2_matmul_batched.launches = 0
f2_apply_scatter.launches = 0
