"""ldpc_erasure_codes_tpu_torch: the LDPC erasure codec in PyTorch and CUDA.

The PyTorch counterpart of :mod:`ldpc_erasure_codes_tpu`, module for module.
Plain tensor code is PyTorch; every kernel that the JAX package writes in
Pallas is a hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at
first use and loaded with ``ctypes`` (:mod:`.ops._build`). Each kernel has a
plain PyTorch version beside it, which a wrapper runs only for tensors that
lie on the CPU.

This package imports ``torch`` and ``numpy`` and never ``jax``, nor anything
of the JAX package: it keeps its own copy of the shipped codes in
``ldpc_erasure_codes_tpu_torch/data/codes/*.npz`` and reads them as data.

Public contract (the JAX package's): values are ``(B, n, W)`` 32-bit words
(held as ``torch.int32``) for binary codes and ``(B, n, Wbytes)`` uint8
bytes (``Wbytes % 4 == 0``) for GF(256) codes and Reed-Solomon, erasures
are a ``(B, n)`` bool mask, and erased value slots hold zero.
"""

from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures
from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode, from_h_dense, from_vlist, get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.rs import rs_code, rs_decode, rs_decode_wide, rs_encode

__version__ = "0.1.0"

__all__ = [
    "CodeArrays",
    "LDPCCode",
    "apply_erasures",
    "code_arrays",
    "encode_packed",
    "from_h_dense",
    "from_vlist",
    "get_code",
    "hybrid_decode",
    "hybrid_decode_escalated",
    "iid_erasures",
    "peel_decode",
    "rs_code",
    "rs_decode",
    "rs_decode_wide",
    "rs_encode",
]
