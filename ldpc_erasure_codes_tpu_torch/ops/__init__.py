"""Code tables and the encode and peel operations (kernel wrappers and their
plain PyTorch versions)."""

from ldpc_erasure_codes_tpu_torch.ops.arrays import (
    CodeArrays,
    code_arrays,
    code_arrays_from_numpy,
    host_arrays,
)
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference

__all__ = [
    "CodeArrays",
    "code_arrays",
    "code_arrays_from_numpy",
    "encode_packed",
    "encode_packed_reference",
    "host_arrays",
    "peel_decode",
    "peel_decode_reference",
]
