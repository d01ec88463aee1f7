"""Reed-Solomon erasure encode and decode over the shared GF(256) machinery.

Counterpart of ``ldpc_erasure_codes_tpu/rs/decode.py``: the decode is the
batched Gauss-Jordan erasure solver on the RS parity-check system, the
same solution as the reference's G-side solve
(Matlab/My_RS_Decode_Optimize_With_GFTables.m:55-91). Payloads are uint8:
(B, k) / (B, n) single bytes, or (B, k, W) / (B, n, W) packets with
W % 4 == 0.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_solve, ge_solve_wide_nb
from ldpc_erasure_codes_tpu_torch.utils import profiling


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(B, n) bytes -> (B, n, 4), the byte in lane 0 and zeros after: the
    packed paths need whole words, and GF(256) work is per byte lane."""
    return torch.nn.functional.pad(x[:, :, None], (0, 3)).contiguous()


def rs_encode(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """Systematic RS encode: (B, k) uint8 -> (B, n), or (B, k, W) packets
    -> (B, n, W), through the GF(256) encoder."""
    if source.dim() == 2:
        return encode_packed(arrays, _lanes(source), gf_order=256)[:, :, 0]
    return encode_packed(arrays, source, gf_order=256)


def rs_decode(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, *, emax: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Erasure-only RS decode with :func:`.ops.ge.ge_solve`. Returns
    (values, erased, failed); failed marks frames with more than n - k
    erasures (the MDS bound; RS has no other rank deficiency)."""
    emax = arrays.m if emax is None else emax
    if values.dim() == 2:
        v, e, f = ge_solve(arrays, _lanes(values), erased, emax=emax, gf_order=256)
        return v[:, :, 0], e, f
    return ge_solve(arrays, values, erased, emax=emax, gf_order=256)


def rs_decode_wide(
    arrays: CodeArrays, values: torch.Tensor, erased: torch.Tensor, *, emax: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packet RS erasure decode, (B, n, W) uint8: the pattern solved once
    per frame on bytes, the transform applied to the W-byte payloads
    (:func:`.ops.ge.ge_solve_wide_nb`, the three GF(256) GE kernels on the
    card). Returns (values, erased, failed) as :func:`rs_decode`."""
    emax = arrays.m if emax is None else emax
    with profiling.span("rs.decode", device=values.device):
        return ge_solve_wide_nb(arrays, values, erased, emax=emax)
