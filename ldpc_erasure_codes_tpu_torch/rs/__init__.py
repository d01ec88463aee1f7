"""Reed-Solomon erasure codes over GF(256)."""

from ldpc_erasure_codes_tpu_torch.rs.code import (
    analytic_rs_fer,
    rs_code,
    rs_generator,
    rs_systematic_generator,
)
from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode, rs_decode_wide, rs_encode

__all__ = [
    "analytic_rs_fer",
    "rs_code",
    "rs_decode",
    "rs_decode_wide",
    "rs_encode",
    "rs_generator",
    "rs_systematic_generator",
]
