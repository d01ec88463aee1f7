"""Code tables as torch tensors on an explicit device.

Counterpart of ``ldpc_erasure_codes_tpu/ops/arrays.py``. :class:`CodeArrays`
holds the fields that the binary encode and peel kernels read, derived in
NumPy exactly as the JAX package's ``_host_arrays`` derives them, so both
sides compute on identical tables (the CPU tests check this field by field).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode

FIELDS = ("vlist_idx", "vlist_len", "enc_src_idx", "enc_par_idx")


@dataclasses.dataclass(frozen=True)
class CodeArrays:
    """Device tables for one code (all ``torch.int32``, contiguous).

    Attributes:
      vlist_idx: (m, dmax) neighbour columns of each check, pad = n.
      vlist_len: (m,) check degrees.
      enc_src_idx: (m, dmax) per parity row, its neighbours in the source
        region (col < k), pad = k.
      enc_par_idx: (m, pmax) per parity row i, the (col - k) indices of its
        strictly-lower parity neighbours (k <= col < k + i), pad = m.
      min_n: one more than the largest neighbour column; the peel wrapper
        refuses codewords shorter than this, so the kernel never indexes
        past a frame.
    """

    vlist_idx: torch.Tensor
    vlist_len: torch.Tensor
    enc_src_idx: torch.Tensor
    enc_par_idx: torch.Tensor
    min_n: int

    @property
    def m(self) -> int:
        return self.vlist_idx.shape[0]

    @property
    def dmax(self) -> int:
        return self.vlist_idx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vlist_idx.device

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}


def host_arrays(code: LDPCCode) -> dict[str, np.ndarray]:
    """The slice's tables as NumPy, derived as ``_host_arrays`` does
    (ldpc_erasure_codes_tpu/ops/arrays.py:98-130).

    The encoder splits each check row of the triangle-form H into its
    source-region neighbours (a parallel gather-XOR) and its strictly-lower
    parity neighbours (the sequential back-substitution); the diagonal
    neighbour ``k + r`` is the row's own parity symbol.
    """
    m, dmax, k = code.m, code.dmax, code.k
    enc_src_idx = np.full((m, dmax), k, dtype=np.int32)
    par_rows: list[list[int]] = []
    for r in range(m):
        s_fill = 0
        par: list[int] = []
        has_diag = False
        for j in range(int(code.vlist_len[r])):
            c = int(code.vlist_idx[r, j])
            if c < k:
                enc_src_idx[r, s_fill] = c
                s_fill += 1
            elif c == k + r:
                has_diag = True
            elif c < k + r:
                par.append(c - k)
            else:
                raise ValueError(f"row {r}: parity neighbour above the diagonal")
        if not has_diag:
            raise ValueError(f"row {r}: triangle diagonal missing")
        par_rows.append(par)
    pmax = max(1, max(len(p) for p in par_rows))
    enc_par_idx = np.full((m, pmax), m, dtype=np.int32)
    for r, par in enumerate(par_rows):
        enc_par_idx[r, : len(par)] = par
    return dict(
        vlist_idx=np.asarray(code.vlist_idx, dtype=np.int32),
        vlist_len=np.asarray(code.vlist_len, dtype=np.int32),
        enc_src_idx=enc_src_idx,
        enc_par_idx=enc_par_idx,
    )


def code_arrays_from_numpy(host: dict, device: torch.device | str) -> CodeArrays:
    """:class:`CodeArrays` from a dict of NumPy tables.

    Takes the port's own :func:`host_arrays` or the dict that the JAX
    package's ``ops.arrays._host_arrays`` returns (extra fields ignored).
    """
    tabs = {f: np.ascontiguousarray(host[f], dtype=np.int32) for f in FIELDS}
    idx, ln = tabs["vlist_idx"], tabs["vlist_len"]
    if ln.shape != idx.shape[:1] or ln.min(initial=1) < 1 or ln.max(initial=0) > idx.shape[1]:
        raise ValueError("vlist_len must hold degrees in 1..dmax, one per check")
    if any(t.min(initial=0) < 0 for t in tabs.values()):
        raise ValueError("negative index in a code table")
    real = np.arange(idx.shape[1])[None, :] < ln[:, None]
    return CodeArrays(
        **{f: torch.from_numpy(t).to(device) for f, t in tabs.items()},
        min_n=int(idx[real].max(initial=-1)) + 1,
    )


def code_arrays(code: LDPCCode, device: torch.device | str) -> CodeArrays:
    return code_arrays_from_numpy(host_arrays(code), device)
