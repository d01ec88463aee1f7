"""GF(2^8) arithmetic: NumPy tables and torch tensor operations."""

from ldpc_erasure_codes_tpu_torch.gf.ops import (
    as_words,
    bits_to_bytes,
    bytes_to_bits,
    gf_inv,
    gf_mul,
    gf_mul_packed,
)
from ldpc_erasure_codes_tpu_torch.gf.tables import (
    DEFAULT_PRIM_POLY,
    GFTables,
    bit_image,
    build_tables,
    gf_inv_matrix_np,
    gf_inv_np,
    gf_matmul_np,
    gf_matvec_np,
    gf_mul_np,
)

__all__ = [
    "DEFAULT_PRIM_POLY",
    "GFTables",
    "as_words",
    "bit_image",
    "bits_to_bytes",
    "build_tables",
    "bytes_to_bits",
    "gf_inv",
    "gf_inv_matrix_np",
    "gf_inv_np",
    "gf_matmul_np",
    "gf_matvec_np",
    "gf_mul",
    "gf_mul_np",
    "gf_mul_packed",
]
