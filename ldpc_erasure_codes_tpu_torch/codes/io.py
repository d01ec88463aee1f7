"""LDPC codes as data: the Vlist form, loaded from the shipped ``.npz`` files.

Counterpart of ``ldpc_erasure_codes_tpu/codes/io.py`` (``load_code``,
``get_code``) and of the fields of ``codes/registry.py::LDPCCode`` that the
binary encode and peel paths read. The JAX package's host modules import
``jax`` (through ``gf/__init__.py``), so this package does not import them:
it reads the same archives with ``np.load`` instead.

Archive format (``codes/io.py::save_code``): ``name``, ``n``, ``k``,
``vlist_idx`` (m, dmax) int32 0-based neighbour columns padded with ``n``,
``vlist_len`` (m,) int32 check degrees, ``vlist_val`` (m, dmax) uint8
coefficients (pad 0), ``rs_n``, ``rs_k``, ``gf_order``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "ldpc_erasure_codes_tpu",
    "data",
    "codes",
)


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
    """

    name: str
    n: int
    k: int
    vlist_idx: np.ndarray
    vlist_len: np.ndarray
    vlist_val: np.ndarray
    gf_order: int = 2

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


def from_vlist(
    name: str,
    n: int,
    k: int,
    vlist_idx,
    vlist_len,
    vlist_val=None,
    gf_order: int = 2,
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
        vlist_val=val, gf_order=int(gf_order),
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
        )


def list_codes() -> list[str]:
    if not os.path.isdir(DATA_DIR):
        return []
    return sorted(f[: -len(".npz")] for f in os.listdir(DATA_DIR) if f.endswith(".npz"))


def get_code(name: str) -> LDPCCode:
    """Load a shipped code by name (e.g. ``n2040_k1530``).

    The GF(256) lifts (``<name>_gf256``) belong to a later slice of the port
    and raise ``NotImplementedError``.
    """
    if name.endswith("_gf256"):
        raise NotImplementedError(
            f"{name!r}: GF(256) codes are not ported yet (binary codes only)"
        )
    path = os.path.join(DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise KeyError(f"unknown code {name!r}; shipped codes: {list_codes()}")
    return load_code(path)
