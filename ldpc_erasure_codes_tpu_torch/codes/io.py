"""LDPC codes as data: the Vlist form, loaded from the shipped ``.npz`` files.

Counterpart of ``ldpc_erasure_codes_tpu/codes/io.py`` (``save_code``,
``load_code``, ``get_code``, the Vlist C-header reader
``parse_vlist_header`` :75 and the MATLAB reader ``load_mat_code`` :124)
and of ``codes/registry.py``: the fields of
``LDPCCode``, ``h_dense`` and ``h_dense_nb``, ``validate`` (:201-212), the
seed-0 GF(256) lift (``lift_to_gf256``, :184-199) and ``from_h_dense``
(:215-253), which the Reed-Solomon codes and the generators use. The JAX
package's host modules import ``jax`` (through ``gf/__init__.py``), so this
package does not import them: it keeps its own byte-identical copy of the
shipped archives in ``ldpc_erasure_codes_tpu_torch/data/codes/`` and reads
them with ``np.load``.

Archive format (``codes/io.py::save_code``): ``name``, ``n``, ``k``,
``vlist_idx`` (m, dmax) int32 0-based neighbour columns padded with ``n``,
``vlist_len`` (m,) int32 check degrees, ``vlist_val`` (m, dmax) uint8
coefficients (pad 0), ``rs_n``, ``rs_k``, ``gf_order``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "codes")


@dataclasses.dataclass(frozen=True, eq=False)
class LDPCCode:
    """An (n, k) LDPC erasure code in Vlist form.

    Attributes:
      name: registry key, e.g. ``"n2040_k1530"``.
      n: codeword length in symbols.
      k: source symbols per codeword.
      vlist_idx: (m, dmax) int32 neighbour columns of each check, pad = n.
      vlist_len: (m,) int32 check degrees.
      vlist_val: (m, dmax) uint8 coefficients on the same support, pad = 0.
      gf_order: 2 for binary codes, 256 for non-binary.
      rs_n / rs_k: the rate-matched Reed-Solomon comparison code (0 if none).
    """

    name: str
    n: int
    k: int
    vlist_idx: np.ndarray
    vlist_len: np.ndarray
    vlist_val: np.ndarray
    gf_order: int = 2
    rs_n: int = 0
    rs_k: int = 0

    def __post_init__(self):
        if self.vlist_idx.ndim != 2 or self.vlist_idx.shape[0] != self.m:
            raise ValueError(
                f"vlist_idx shape {self.vlist_idx.shape}, expected ({self.m}, dmax)"
            )
        if self.vlist_val.shape != self.vlist_idx.shape:
            raise ValueError("vlist_idx and vlist_val shapes differ")
        if self.vlist_len.shape != (self.m,):
            raise ValueError(f"vlist_len shape {self.vlist_len.shape} != ({self.m},)")

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def dmax(self) -> int:
        return self.vlist_idx.shape[1]

    @functools.cached_property
    def h_dense(self) -> np.ndarray:
        """(m, n) uint8 binary parity-check matrix (the Vlist's support)."""
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        rows = np.repeat(np.arange(self.m), self.dmax)
        cols = self.vlist_idx.reshape(-1)
        valid = cols < self.n
        h[rows[valid], cols[valid]] = 1
        return h

    @functools.cached_property
    def h_dense_nb(self) -> np.ndarray:
        """(m, n) uint8 GF(256) parity-check matrix (the coefficients)."""
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        rows = np.repeat(np.arange(self.m), self.dmax)
        cols = self.vlist_idx.reshape(-1)
        valid = cols < self.n
        h[rows[valid], cols[valid]] = self.vlist_val.reshape(-1)[valid]
        return h

    def validate(self) -> None:
        """Structural checks (``registry.py::validate``): degrees in [1,
        dmax], neighbours in [0, n) and distinct, pads n and 0, nonzero
        coefficients on the support. Raises ValueError."""
        for r in range(self.m):
            d = int(self.vlist_len[r])
            idx = self.vlist_idx[r, :d]
            if not 1 <= d <= self.dmax:
                raise ValueError(f"row {r}: bad degree {d}")
            if not np.all((idx >= 0) & (idx < self.n)):
                raise ValueError(f"row {r}: index out of range")
            if len(np.unique(idx)) != d:
                raise ValueError(f"row {r}: duplicate neighbor")
            if not np.all(self.vlist_idx[r, d:] == self.n):
                raise ValueError(f"row {r}: bad padding")
            if not np.all(self.vlist_val[r, :d] >= 1):
                raise ValueError(f"row {r}: zero coefficient")
            if not np.all(self.vlist_val[r, d:] == 0):
                raise ValueError(f"row {r}: bad value padding")

    def lift_to_gf256(self, seed: int = 0, name: str | None = None) -> "LDPCCode":
        """Non-binary lift: every 1 of H becomes a uniform draw from 1..255,
        drawn over the Vlist support in row-major order, as
        ``registry.py::lift_to_gf256`` (ErasureCodes_NonBinaryLDPCSim.m:52-58)."""
        rng = np.random.default_rng(seed)
        vals = self.vlist_val.copy()
        support = self.vlist_idx < self.n
        vals[support] = rng.integers(1, 256, size=int(support.sum()), dtype=np.uint8)
        return dataclasses.replace(
            self, name=name or f"{self.name}_gf256", vlist_val=vals, gf_order=256
        )


def from_h_dense(h, name: str, rs_n: int = 0, rs_k: int = 0, dmax: int | None = None) -> LDPCCode:
    """A code from a dense (m, n) parity-check matrix, which may carry
    GF(256) coefficients (gf_order 256 when any entry exceeds 1), as
    ``registry.py::from_h_dense`` (:215-236). The Vlist is padded to
    ``dmax`` slots, or to the largest check degree when ``dmax`` is None
    or 0."""
    if hasattr(h, "toarray"):
        h = h.toarray()
    h = np.asarray(h)
    if h.dtype in (np.float32, np.float64) and not np.all(h == np.round(h)):
        raise ValueError("h must hold integers")
    h = h.astype(np.int64)
    m, n = h.shape
    degs = (h != 0).sum(axis=1)
    dm = dmax or int(degs.max())
    if dm < degs.max():
        raise ValueError(f"dmax={dmax} is below the largest check degree {int(degs.max())}")
    vlist_idx = np.full((m, dm), n, dtype=np.int32)
    vlist_val = np.zeros((m, dm), dtype=np.uint8)
    for r in range(m):
        cols = np.nonzero(h[r])[0]
        vlist_idx[r, : cols.size] = cols
        vlist_val[r, : cols.size] = h[r, cols]
    return LDPCCode(
        name=name, n=n, k=n - m, vlist_idx=vlist_idx, vlist_len=degs.astype(np.int32),
        vlist_val=vlist_val, gf_order=256 if np.any(h > 1) else 2, rs_n=rs_n, rs_k=rs_k,
    )


def from_vlist(
    name: str,
    n: int,
    k: int,
    vlist_idx,
    vlist_len,
    vlist_val=None,
    gf_order: int = 2,
    rs_n: int = 0,
    rs_k: int = 0,
) -> LDPCCode:
    """Build a code from Vlist arrays (e.g. a generated test code handed
    over as NumPy). ``vlist_val`` defaults to ones on the support."""
    idx = np.asarray(vlist_idx, dtype=np.int32)
    ln = np.asarray(vlist_len, dtype=np.int32)
    if vlist_val is None:
        val = (np.arange(idx.shape[1])[None, :] < ln[:, None]).astype(np.uint8)
    else:
        val = np.asarray(vlist_val, dtype=np.uint8)
    return LDPCCode(
        name=name, n=int(n), k=int(k), vlist_idx=idx, vlist_len=ln,
        vlist_val=val, gf_order=int(gf_order), rs_n=int(rs_n), rs_k=int(rs_k),
    )


def _parse_int_table(text: str, name: str) -> np.ndarray:
    """Extract a 2-D C integer array initializer ``name[..][..] = { {..}, .. }``."""
    m = re.search(rf"{name}\s*\[\s*\d+\s*\]\s*\[\s*\d+\s*\]\s*=\s*\{{(.*?)\}}\s*;", text, re.S)
    if not m:
        raise ValueError(f"array {name} not found")
    rows = []
    for rm in re.finditer(r"\{([^{}]*)\}", m.group(1)):
        rows.append([int(v) for v in rm.group(1).replace("\n", " ").split(",") if v.strip()])
    width = max(len(r) for r in rows)
    out = np.zeros((len(rows), width), dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def parse_vlist_header(path: str) -> list[LDPCCode]:
    """Parse an OpenCL Vlist data header into LDPCCode objects.

    Supports both the master multi-code layout (``ldpc_params[N][6]`` rows =
    {n, k, first Vlist row, last Vlist row, RS_n, RS_k} +
    ``parity_check_mat_Vlist_master`` rows = [degree, 1-based columns...,
    0 padding], OpenCL/device/LDPC_Vlist_data.h:10-20) and the single-code
    device layout (``ldpc_params[N][2]`` + ``parity_check_mat_Vlist``,
    OpenCL/device/n2000_k1000_no6cycle_ldpc_Vlist_device.h:6-16).
    """
    with open(path) as f:
        text = f.read()
    params = _parse_int_table(text, "ldpc_params")
    try:
        vlist = _parse_int_table(text, "parity_check_mat_Vlist_master")
    except ValueError:
        vlist = _parse_int_table(text, "parity_check_mat_Vlist")
    codes = []
    for row in params:
        if params.shape[1] >= 6:
            n, k, first, last, rs_n, rs_k = (int(v) for v in row[:6])
        else:
            # Single-code device layout: the Vlist holds only the code whose
            # row count matches; other params rows are informational.
            n, k = int(row[0]), int(row[1])
            if n - k != vlist.shape[0]:
                continue
            first, last, rs_n, rs_k = 0, n - k - 1, 0, 0
        block = vlist[first : last + 1]
        degs = block[:, 0].astype(np.int32)
        dmax = int(degs.max())
        idx = block[:, 1 : dmax + 1].astype(np.int32) - 1  # to 0-based
        pad = np.arange(dmax)[None, :] >= degs[:, None]
        idx[pad] = n
        vals = np.where(pad, 0, 1).astype(np.uint8)
        codes.append(LDPCCode(
            name=f"n{n}_k{k}", n=n, k=k, vlist_idx=idx, vlist_len=degs, vlist_val=vals,
            rs_n=rs_n, rs_k=rs_k, gf_order=2,
        ))
    return codes


def load_mat_code(path: str, name: str | None = None, rs_n: int = 0, rs_k: int = 0) -> LDPCCode:
    """Load a code from a MATLAB ``.mat`` file holding ``H_sparse``
    (and optionally ``H_sparse_nb``), through ``scipy.io``."""
    import scipy.io as sio

    d = sio.loadmat(path)
    key = "H_sparse_nb" if "H_sparse_nb" in d else "H_sparse"
    h = d[key]
    if hasattr(h, "toarray"):
        h = h.toarray()
    if name is None:
        m, n = h.shape
        name = f"n{n}_k{n - m}"
    return from_h_dense(h, name=name, rs_n=rs_n, rs_k=rs_k)


def save_code(code: LDPCCode, path: str) -> None:
    """Write ``code`` as the ``.npz`` archive :func:`load_code` reads (the
    JAX package's format, ``codes/io.py::save_code``)."""
    np.savez_compressed(
        path,
        name=np.array(code.name),
        n=code.n,
        k=code.k,
        vlist_idx=code.vlist_idx,
        vlist_len=code.vlist_len,
        vlist_val=code.vlist_val,
        rs_n=code.rs_n,
        rs_k=code.rs_k,
        gf_order=code.gf_order,
    )


def load_code(path: str) -> LDPCCode:
    with np.load(path) as z:
        return from_vlist(
            name=str(z["name"]),
            n=int(z["n"]),
            k=int(z["k"]),
            vlist_idx=z["vlist_idx"],
            vlist_len=z["vlist_len"],
            vlist_val=z["vlist_val"],
            gf_order=int(z["gf_order"]),
            rs_n=int(z["rs_n"]),
            rs_k=int(z["rs_k"]),
        )


def list_codes() -> list[str]:
    if not os.path.isdir(DATA_DIR):
        return []
    return sorted(f[: -len(".npz")] for f in os.listdir(DATA_DIR) if f.endswith(".npz"))


def get_code(name: str) -> LDPCCode:
    """Load a shipped code by name (e.g. ``n2040_k1530``).

    ``<name>_gf256`` is the deterministic seed-0 GF(256) lift of the shipped
    binary code ``<name>`` (``io.py::get_code`` :146-152).
    """
    if name.endswith("_gf256"):
        return get_code(name[: -len("_gf256")]).lift_to_gf256(seed=0)
    path = os.path.join(DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise KeyError(f"unknown code {name!r}; shipped codes: {list_codes()}")
    return load_code(path)
