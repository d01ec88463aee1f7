"""Systematic triangular encode of packed symbols: (B, k, W) -> (B, n, W).

Counterpart of ``ldpc_erasure_codes_tpu/ops/encode.py::encode_packed``
(:57-137) and of the TPU kernel ``ops/pallas_encode.py::encode_packed_vmem``
(:223-379), which compute the same codewords. :func:`encode_packed` launches
the CUDA kernel ``csrc/encode.cu`` for CUDA tensors and runs
:func:`encode_packed_reference` for CPU tensors.

Binary codes take int32 words. GF(256) codes take uint8 byte symbols
(W % 4 == 0), viewed as int32 words of four bytes for the arithmetic, and
parity row i is ``dinv_i * (sum src_val * src + sum par_val * parity_j)``
(ErasureCodes_NonBinaryLDPCSim.m:172-182), the function of
``encode_packed_vmem``'s GF(256) branch.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays


def _check(arrays: CodeArrays, source: torch.Tensor, gf_order: int) -> torch.Tensor:
    """Validate; returns the int32 word view of ``source``."""
    if gf_order not in (2, 256):
        raise ValueError(f"gf_order must be 2 or 256, got {gf_order}")
    if source.dim() != 3 or source.shape[2] < 1:
        raise ValueError(f"source must be (B, k, W) with W >= 1, got {tuple(source.shape)}")
    if source.device != arrays.device:
        raise ValueError(f"source on {source.device}, code tables on {arrays.device}")
    if gf_order == 256:
        return as_words(source, "source")
    if source.dtype != torch.int32:
        raise TypeError(f"source must be torch.int32 words, got {source.dtype}")
    if not source.is_contiguous():
        raise ValueError("source must be contiguous")
    return source


def _bytes_out(words: torch.Tensor, gf_order: int) -> torch.Tensor:
    return words.view(torch.uint8) if gf_order == 256 else words


def encode_packed_reference(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Plain PyTorch encode, as encode.py:111-137: a gather-MAC over each
    parity row's source neighbours, then the back-substitution over parity
    rows in order (multiplies by coefficients only for GF(256))."""
    words = _check(arrays, source, gf_order)
    nb = gf_order == 256
    b, k, w = words.shape
    m = arrays.m
    src_p = torch.cat([words, words.new_zeros(b, 1, w)], dim=1)  # pad col k reads zero
    src_idx = arrays.enc_src_idx.long()
    t = words.new_zeros(b, m, w)
    for s in range(src_idx.shape[1]):
        term = src_p[:, src_idx[:, s], :]
        t ^= gf_mul_packed(term, arrays.enc_src_val[:, s, None]) if nb else term
    parity = words.new_zeros(b, m, w)
    par_val = arrays.enc_par_val.tolist()
    dinv = arrays.enc_diag_inv.tolist()
    for i, row in enumerate(arrays.enc_par_idx.tolist()):
        acc = t[:, i]
        for p, c in zip(row, par_val[i]):
            if p < m:
                acc = acc ^ (gf_mul_packed(parity[:, p], c) if nb else parity[:, p])
        parity[:, i] = gf_mul_packed(acc, dinv[i]) if nb else acc
    return _bytes_out(torch.cat([words, parity], dim=1), gf_order)


def encode_packed(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Systematic encode of ``source`` -> (B, n, W).

    ``source`` is (B, k, W) int32 words for ``gf_order=2`` and (B, k, W)
    uint8 bytes (W % 4 == 0) for ``gf_order=256``; the codewords come back
    in the same type. CPU tensors take :func:`encode_packed_reference`;
    CUDA tensors launch the kernel (or raise). ``encode_packed.launches``
    counts binary launches, ``encode_packed.launches_gf256`` GF(256) ones.
    """
    words = _check(arrays, source, gf_order)
    if words.device.type == "cpu":
        return encode_packed_reference(arrays, source, gf_order=gf_order)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    b, k, w = words.shape
    m, pmax = arrays.enc_par_idx.shape
    nb = gf_order == 256
    out = torch.empty((b, k + m, w), dtype=torch.int32, device=words.device)
    rc = _build.library().ldpc_encode_launch(
        words.data_ptr(), arrays.enc_src_idx.data_ptr(), arrays.enc_par_idx.data_ptr(),
        arrays.enc_src_val.data_ptr(), arrays.enc_par_val.data_ptr(),
        arrays.enc_diag_inv.data_ptr(), out.data_ptr(), b, k, m, w,
        arrays.enc_src_idx.shape[1], pmax, int(nb),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    _build.check(rc, "ldpc_encode_launch")
    if nb:
        encode_packed.launches_gf256 += 1
    else:
        encode_packed.launches += 1
    return _bytes_out(out, gf_order)


encode_packed.launches = 0
encode_packed.launches_gf256 = 0


def scalar_words(symbols: torch.Tensor, gf_order: int) -> torch.Tensor:
    """Scalar uint8 symbols (..., n) as one-symbol packed frames
    (..., n, 1) int32: the symbol itself as a word (binary), or its byte
    zero-padded to four (GF(256), byte 0 of the word)."""
    if symbols.dtype != torch.uint8:
        raise TypeError(f"scalar symbols must be torch.uint8, got {symbols.dtype}")
    if gf_order == 256:
        return torch.nn.functional.pad(symbols[..., None], (0, 3)).contiguous().view(torch.int32)
    return symbols.to(torch.int32)[..., None].contiguous()


def from_scalar_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`scalar_words`: the low byte of each one-word
    symbol, (..., n, 1) int32 -> (..., n) uint8."""
    return (words[..., 0] & 0xFF).to(torch.uint8)


def _encode_scalar(arrays: CodeArrays, source: torch.Tensor, gf_order: int) -> torch.Tensor:
    lead = source.shape[:-1]
    words = scalar_words(source.reshape(-1, source.shape[-1]), gf_order)
    if gf_order == 256:
        cw = encode_packed(arrays, words.view(torch.uint8), gf_order=256).view(torch.int32)
    else:
        cw = encode_packed(arrays, words)
    cw = from_scalar_words(cw)
    return cw.reshape(*lead, cw.shape[-1])


def encode(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """Binary systematic encode of scalar symbols: (..., k) uint8 -> (..., n)
    uint8, as ``ops/encode.py::encode`` (:26-32). A systematic codeword is
    unique, so the bits ride through the triangular encoder as one-word
    symbols; the parity is taken mod 2 (the low bit), as JAX's mod-2
    product is, and the source part is returned as given."""
    cw = _encode_scalar(arrays, source, 2)
    k = source.shape[-1]
    return torch.cat([source, cw[..., k:] & 1], dim=-1)


def encode_nb(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """GF(256) systematic encode of scalar byte symbols: (..., k) uint8 ->
    (..., n) uint8, as ``ops/encode.py::encode_nb`` (:35-43). Each byte
    rides through the triangular encoder as a zero-padded four-byte symbol
    (the GF(256) word mode, whose other three bytes stay zero)."""
    return _encode_scalar(arrays, source, 256)
