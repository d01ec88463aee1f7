"""Code tables, the encode and peel operations, the Gauss-Jordan solvers
over GF(2) and GF(256), the rank check and the fused channel (kernel
wrappers and their plain PyTorch versions).

Two names differ from the JAX package's ``ops``: ``peel_decode`` here is
the peel kernel, JAX's ``peel_decode_vmem``, and JAX's XLA ``peel_decode``
is ``peel_decode_jacobi``."""

from ldpc_erasure_codes_tpu_torch.ops.arrays import (
    CodeArrays,
    code_arrays,
    code_arrays_from_numpy,
    device_arrays,
    host_arrays,
)
from ldpc_erasure_codes_tpu_torch.ops.channel import (
    channel_apply_per64,
    channel_apply_per64_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.compact import (
    compact_ge_rank,
    compact_ge_solve,
    residual_order,
)
from ldpc_erasure_codes_tpu_torch.ops.elim import (
    f2_eliminate,
    f2_eliminate_reference,
    gf256_eliminate,
    gf256_eliminate_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.encode import (
    encode,
    encode_nb,
    encode_packed,
    encode_packed_reference,
    encode_scan,
    encode_wide,
    make_packed_encoder,
)
from ldpc_erasure_codes_tpu_torch.ops.ge import (
    erased_indices,
    ge_rank_check,
    ge_solve,
    ge_solve_packed,
    ge_solve_wide_nb,
)
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_scatter,
    f2_apply_scatter_reference,
    f2_matmul_batched,
    f2_matmul_batched_reference,
    f2_matrix_rows,
    f2_matvec_wide,
    f2_matvec_wide_reference,
    gf_apply_scatter,
    gf_apply_scatter_reference,
    gf_matmul_batched,
    gf_matmul_batched_reference,
    gf_matvec_wide,
    gf_matvec_wide_reference,
    matrix_rows,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    peel_decode_jacobi,
    peel_decode_mask,
    peel_decode_wide,
    peel_decode_with_history,
    peel_step_gather,
    peel_step_matmul,
    peel_step_seq_blocks,
    peel_step_worklist,
)
from ldpc_erasure_codes_tpu_torch.ops.rank import f2_rank_check, f2_rank_check_reference
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo, syndrome_from_topo_reference

__all__ = [
    "CodeArrays",
    "channel_apply_per64",
    "channel_apply_per64_reference",
    "code_arrays",
    "code_arrays_from_numpy",
    "compact_ge_rank",
    "compact_ge_solve",
    "device_arrays",
    "encode",
    "encode_nb",
    "encode_packed",
    "encode_packed_reference",
    "encode_scan",
    "encode_wide",
    "erased_indices",
    "f2_apply_scatter",
    "f2_apply_scatter_reference",
    "f2_eliminate",
    "f2_eliminate_reference",
    "f2_matmul_batched",
    "f2_matmul_batched_reference",
    "f2_matrix_rows",
    "f2_matvec_wide",
    "f2_matvec_wide_reference",
    "f2_rank_check",
    "f2_rank_check_reference",
    "ge_rank_check",
    "ge_solve",
    "ge_solve_packed",
    "ge_solve_wide_nb",
    "gf256_eliminate",
    "gf256_eliminate_reference",
    "gf_apply_scatter",
    "gf_apply_scatter_reference",
    "gf_matmul_batched",
    "gf_matmul_batched_reference",
    "gf_matvec_wide",
    "gf_matvec_wide_reference",
    "host_arrays",
    "hybrid_decode",
    "hybrid_decode_escalated",
    "make_packed_encoder",
    "matrix_rows",
    "peel_decode",
    "peel_decode_jacobi",
    "peel_decode_mask",
    "peel_decode_reference",
    "peel_decode_wide",
    "peel_decode_with_history",
    "peel_step_gather",
    "peel_step_matmul",
    "peel_step_seq_blocks",
    "peel_step_worklist",
    "residual_order",
    "syndrome_from_topo",
    "syndrome_from_topo_reference",
]
