"""Code tables as torch tensors on an explicit device.

Counterpart of ``ldpc_erasure_codes_tpu/ops/arrays.py``. :class:`CodeArrays`
holds the fields that the encode, peel and Gauss-Jordan kernels read, over
GF(2) and GF(256), derived in NumPy exactly as the JAX package's
``_host_arrays`` derives them (:86-171), so both sides compute on identical
tables (the CPU tests check this field by field). Binary codes carry
all-ones coefficients, so their GF(256) fields are ones on the support.
It also holds the packed-bit helpers that the GF(2) elimination and the
bit-matrix products share: bit ``j`` of a row lives in bit ``j & 31`` of
word ``j >> 5`` (LSB first, the JAX package's ``_bits_to_words``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode
from ldpc_erasure_codes_tpu_torch.gf.tables import build_tables

FIELDS = (
    "vlist_idx", "vlist_len", "clist_idx", "clist_len", "enc_src_idx", "enc_par_idx",
    "check_groups",
)
# GF(256) coefficient tables, uint8, on the supports of the index tables.
NB_FIELDS = ("h_nb", "vlist_val", "vlist_inv_val", "enc_src_val", "enc_par_val", "enc_diag_inv")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 values (..., N) -> packed int32 words (..., ceil(N/32)), LSB
    first; bits past N are zero."""
    *lead, nb = bits.shape
    nw = -(-nb // 32)
    b8 = torch.nn.functional.pad(bits.to(torch.uint8), (0, 32 * nw - nb)).reshape(*lead, 4 * nw, 8)
    weights = torch.arange(8, dtype=torch.uint8, device=bits.device)
    packed = (b8 << weights).sum(dim=-1, dtype=torch.uint8)  # (..., 4 * nw) bytes
    return packed.contiguous().view(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Packed int32 words (..., K) -> uint8 0/1 values (..., 32K), LSB first."""
    by = words.contiguous().view(torch.uint8)  # (..., 4K), little-endian
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((by[..., None] >> shifts) & 1).reshape(*words.shape[:-1], words.shape[-1] * 32)


@dataclasses.dataclass(frozen=True)
class CodeArrays:
    """Device tables for one code (``torch.int32`` unless noted, contiguous).

    Attributes:
      h: (m, n) ``torch.int8`` 0/1 support of H (``_host_arrays``' ``h``).
      h_words: (m, ceil(n/32)) int32, ``h`` packed (:func:`pack_bits`), for
        the dense syndrome product; derived from ``h``.
      h_nb: (m, n) uint8 GF(256) coefficients of H (``h`` for binary codes).
      vlist_idx: (m, dmax) neighbour columns of each check, pad = n.
      vlist_len: (m,) check degrees.
      vlist_val: (m, dmax) uint8 coefficients of the neighbours, pad 0.
      vlist_inv_val: (m, dmax) uint8 their inverses, pad 0.
      clist_idx: (n, cmax) the checks of each symbol, in check order, pad = m
        (``code.clist``, registry.py:98-121).
      clist_len: (n,) symbol degrees.
      enc_src_idx: (m, dmax) per parity row, its neighbours in the source
        region (col < k), pad = k.
      enc_src_val: (m, dmax) uint8 their coefficients, pad 0.
      enc_par_idx: (m, pmax) per parity row i, the (col - k) indices of its
        strictly-lower parity neighbours (k <= col < k + i), pad = m.
      enc_par_val: (m, pmax) uint8 their coefficients, pad 0.
      enc_diag_inv: (m,) uint8 inverse of each row's diagonal coefficient.
      check_groups: (ngroups, 4) consecutive checks grouped greedily into
        pairwise-disjoint runs of at most 4 (no shared symbol), pad = m: the
        "grouped" peel schedule's visit order (arrays.py:132-150).
      min_n: one more than the largest neighbour column; the peel wrapper
        refuses codewords shorter than this, so the kernel never indexes
        past a frame.
    """

    h: torch.Tensor
    h_words: torch.Tensor
    h_nb: torch.Tensor
    vlist_idx: torch.Tensor
    vlist_len: torch.Tensor
    vlist_val: torch.Tensor
    vlist_inv_val: torch.Tensor
    clist_idx: torch.Tensor
    clist_len: torch.Tensor
    enc_src_idx: torch.Tensor
    enc_src_val: torch.Tensor
    enc_par_idx: torch.Tensor
    enc_par_val: torch.Tensor
    enc_diag_inv: torch.Tensor
    check_groups: torch.Tensor
    min_n: int

    @functools.cached_property
    def h_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`.nbmm.f2_matrix_rows` of ``h_words`` over the n columns
        (the list route of ``f2_matvec_wide``), built at first use."""
        from ldpc_erasure_codes_tpu_torch.ops.nbmm import f2_matrix_rows

        return f2_matrix_rows(self.h_words, self.n)

    @functools.cached_property
    def enc_levels(self):
        """:func:`.encode.encode_levels`: the parity rows in level order
        with their neighbour lists (the encode's slab route), built at
        first use."""
        from ldpc_erasure_codes_tpu_torch.ops.encode import encode_levels

        return encode_levels(self)

    @functools.cached_property
    def vlist_tiles(self):
        """:func:`.nbmm.matrix_tiles` of the Vlist (H's dense route for
        ``gf_matvec_wide``, None for a sparse H), built at first use."""
        from ldpc_erasure_codes_tpu_torch.ops.nbmm import matrix_tiles

        return matrix_tiles(self.vlist_idx, self.vlist_val, self.n)

    @property
    def m(self) -> int:
        return self.vlist_idx.shape[0]

    @property
    def n(self) -> int:
        return self.h.shape[1]

    @property
    def dmax(self) -> int:
        return self.vlist_idx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vlist_idx.device

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f).cpu().numpy() for f in (*FIELDS, *NB_FIELDS, "h")}


def host_arrays(code: LDPCCode) -> dict[str, np.ndarray]:
    """The code's tables as NumPy, derived as ``_host_arrays`` does
    (ldpc_erasure_codes_tpu/ops/arrays.py:86-171).

    ``h`` is the 0/1 support of H as int8, ``(h_dense != 0)`` there.

    The encoder splits each check row of the triangle-form H into its
    source-region neighbours (a parallel gather-MAC) and its strictly-lower
    parity neighbours (the sequential back-substitution); the diagonal
    neighbour ``k + r`` is the row's own parity symbol, whose coefficient's
    inverse closes the row.
    """
    inv = build_tables().inv
    m, dmax, k = code.m, code.dmax, code.k
    enc_src_idx = np.full((m, dmax), k, dtype=np.int32)
    enc_src_val = np.zeros((m, dmax), dtype=np.uint8)
    diag = np.zeros(m, dtype=np.uint8)
    par_rows: list[list[tuple[int, int]]] = []
    for r in range(m):
        s_fill = 0
        par: list[tuple[int, int]] = []
        for j in range(int(code.vlist_len[r])):
            c = int(code.vlist_idx[r, j])
            v = int(code.vlist_val[r, j])
            if c < k:
                enc_src_idx[r, s_fill] = c
                enc_src_val[r, s_fill] = v
                s_fill += 1
            elif c == k + r:
                diag[r] = v
            elif c < k + r:
                par.append((c - k, v))
            else:
                raise ValueError(f"row {r}: parity neighbour above the diagonal")
        if diag[r] == 0:
            raise ValueError(f"row {r}: triangle diagonal missing")
        par_rows.append(par)
    pmax = max(1, max(len(p) for p in par_rows))
    enc_par_idx = np.full((m, pmax), m, dtype=np.int32)
    enc_par_val = np.zeros((m, pmax), dtype=np.uint8)
    for r, par in enumerate(par_rows):
        for j, (c, v) in enumerate(par):
            enc_par_idx[r, j] = c
            enc_par_val[r, j] = v
    vlist_val = np.asarray(code.vlist_val, dtype=np.uint8)
    clist_idx, clist_len = clist(code.vlist_idx, code.vlist_len, code.n)
    return dict(
        h=_support(code.vlist_idx, code.vlist_len, code.n),
        h_nb=code.h_dense_nb,
        vlist_idx=np.asarray(code.vlist_idx, dtype=np.int32),
        vlist_len=np.asarray(code.vlist_len, dtype=np.int32),
        vlist_val=vlist_val,
        vlist_inv_val=inv[vlist_val],
        clist_idx=clist_idx,
        clist_len=clist_len,
        check_groups=check_groups(code.vlist_idx, code.vlist_len),
        enc_src_idx=enc_src_idx,
        enc_src_val=enc_src_val,
        enc_par_idx=enc_par_idx,
        enc_par_val=enc_par_val,
        enc_diag_inv=inv[diag],
    )


def clist(vlist_idx: np.ndarray, vlist_len: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The symbol -> checks adjacency: (clist_idx (n, cmax) int32, each
    symbol's checks in ascending order, pad = m; clist_len (n,) int32), as
    ``LDPCCode.clist`` (registry.py:98-121; cmax >= 1)."""
    m = vlist_idx.shape[0]
    real = np.arange(vlist_idx.shape[1])[None, :] < np.asarray(vlist_len)[:, None]
    rows, slots = np.nonzero(real)  # row-major: ascending check within each symbol
    cols = np.asarray(vlist_idx)[rows, slots]
    deg = np.bincount(cols, minlength=n)
    order = np.argsort(cols, kind="stable")
    pos = np.arange(cols.size) - np.repeat(np.cumsum(deg) - deg, deg)
    idx = np.full((n, int(deg.max(initial=1))), m, dtype=np.int32)
    idx[cols[order], pos] = rows[order]
    return idx, deg.astype(np.int32)


def check_groups(vlist_idx: np.ndarray, vlist_len: np.ndarray) -> np.ndarray:
    """Consecutive checks grouped greedily into pairwise-disjoint runs of at
    most 4, (ngroups, 4) int32, pad = m (arrays.py:132-150)."""
    m = vlist_idx.shape[0]
    sets = [set(vlist_idx[r, : int(vlist_len[r])].tolist()) for r in range(m)]
    groups: list[list[int]] = []
    syms: set[int] = set()
    for c in range(m):
        if groups and len(groups[-1]) < 4 and not (sets[c] & syms):
            groups[-1].append(c)
            syms |= sets[c]
        else:
            groups.append([c])
            syms = set(sets[c])
    out = np.full((len(groups), 4), m, dtype=np.int32)
    for i, grp in enumerate(groups):
        out[i, : len(grp)] = grp
    return out


def _support(vlist_idx: np.ndarray, vlist_len: np.ndarray, n: int) -> np.ndarray:
    """(m, n) int8 0/1 matrix with a one at every Vlist neighbour."""
    m, dmax = vlist_idx.shape
    real = np.arange(dmax)[None, :] < np.asarray(vlist_len)[:, None]
    h = np.zeros((m, n), dtype=np.int8)
    h[np.nonzero(real)[0], np.asarray(vlist_idx)[real]] = 1
    return h


def code_arrays_from_numpy(host: dict, device: torch.device | str) -> CodeArrays:
    """:class:`CodeArrays` from a dict of NumPy tables.

    Takes the port's own :func:`host_arrays` or the dict that the JAX
    package's ``ops.arrays._host_arrays`` returns (extra fields ignored).
    ``h`` must be the support of the Vlist and of ``h_nb``; ``h_words`` is
    packed from it.
    """
    tabs = {f: np.ascontiguousarray(host[f], dtype=np.int32) for f in FIELDS}
    idx, ln = tabs["vlist_idx"], tabs["vlist_len"]
    if ln.shape != idx.shape[:1] or ln.min(initial=1) < 1 or ln.max(initial=0) > idx.shape[1]:
        raise ValueError("vlist_len must hold degrees in 1..dmax, one per check")
    if any(t.min(initial=0) < 0 for t in tabs.values()):
        raise ValueError("negative index in a code table")
    real = np.arange(idx.shape[1])[None, :] < ln[:, None]
    min_n = int(idx[real].max(initial=-1)) + 1
    h = np.asarray(host["h"])
    if h.ndim != 2 or h.shape[0] != idx.shape[0] or h.shape[1] < min_n:
        raise ValueError(f"h shape {h.shape} does not fit {idx.shape[0]} checks of the Vlist")
    h = (h != 0).astype(np.int8)
    if not np.array_equal(h, _support(idx, ln, h.shape[1])):
        raise ValueError("h is not the support of the Vlist")
    cl_idx, cl_len = clist(idx, ln, h.shape[1])
    if not (np.array_equal(tabs["clist_idx"], cl_idx) and np.array_equal(tabs["clist_len"], cl_len)):
        raise ValueError("clist_idx/clist_len are not the Vlist's symbol -> checks adjacency")
    if tabs["check_groups"].ndim != 2 or tabs["check_groups"].shape[1] != 4:
        raise ValueError(f"check_groups shape {tabs['check_groups'].shape} != (ngroups, 4)")
    nb = {f: np.ascontiguousarray(host[f], dtype=np.uint8) for f in NB_FIELDS}
    if nb["h_nb"].shape != h.shape or not np.array_equal(nb["h_nb"] != 0, h != 0):
        raise ValueError("h_nb does not have the support of h")
    for f, like in (("vlist_val", "vlist_idx"), ("vlist_inv_val", "vlist_idx"),
                    ("enc_src_val", "enc_src_idx"), ("enc_par_val", "enc_par_idx")):
        if nb[f].shape != tabs[like].shape:
            raise ValueError(f"{f} shape {nb[f].shape} != {like} shape {tabs[like].shape}")
    if nb["enc_diag_inv"].shape != ln.shape:
        raise ValueError(f"enc_diag_inv shape {nb['enc_diag_inv'].shape} != ({ln.shape[0]},)")
    h_t = torch.from_numpy(h).to(device)
    h_words = pack_bits(h_t)
    return CodeArrays(
        h=h_t,
        h_words=h_words.contiguous(),
        **{f: torch.from_numpy(t).to(device) for f, t in tabs.items()},
        **{f: torch.from_numpy(t).to(device) for f, t in nb.items()},
        min_n=min_n,
    )


def code_arrays(code: LDPCCode, device: torch.device | str) -> CodeArrays:
    return code_arrays_from_numpy(host_arrays(code), device)


def device_arrays(code: LDPCCode, device: torch.device | str | None = None) -> CodeArrays:
    """``ops/arrays.py::device_arrays``: :func:`code_arrays` on the CUDA
    card, or on ``device`` where the caller names one (raises where there
    is no card and none is named)."""
    from ldpc_erasure_codes_tpu_torch.utils.device import cuda_device

    return code_arrays(code, cuda_device() if device is None else device)
