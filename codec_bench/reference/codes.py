"""The codes and their systematic encoders, worked out from first principles.

A codeword is ``[source | parity]``: the k source symbols first, then the
m = n - k parity symbols. Every symbol is ``W`` int32 words (``4W`` bytes).

* Binary LDPC: ``H = [Hs | Hp]`` from the frozen ``.npz`` (its Vlist: each
  check's neighbour columns). ``H c = 0`` gives ``parity = Hp^-1 Hs source``
  over GF(2), the same map on every bit of a symbol.
* GF(256) LDPC, a lift of a binary one: the same Vlist, each 1 of H replaced
  by the coefficient that the frozen lift file (``vlist_val``) holds in its
  place. ``H c = 0`` gives ``parity = P^T source`` over GF(2^8) with
  ``P = (Hp^-1 Hs)^T``, on every byte of a symbol.
* RS(n, k) over GF(2^8): the Vandermonde generator ``G[r, c] = alpha^(r c)``,
  its systematic form ``inv(G[:, :k]) G = [I | P]``, ``parity = P^T source``
  on every byte of a symbol.

Every parity map becomes one dense 0/1 matrix ``A`` over the bits of an
element (a bit for the binary code, a byte's 8 bits for the GF(2^8) codes), so
one encoder serves all: unpack the source's bits, one matrix product, reduce
mod 2, pack. The products are exact: the contraction is cut into pieces of at
most ``EXACT_SUM`` = 2048 bits, so every sum is an integer of at most 2048,
which float16 and float32 hold exactly, and the pieces' parities are added mod
2. The binary code (1530 bits) and RS (8 · 192 = 1536) take one piece; the
lifted (2040, 1530) code sums over 8 · 1530 = 12,240 bits and takes six.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# The longest sum float16 holds exactly: every integer up to 2^11 is a float16.
EXACT_SUM = 2048


def read_vlist(path: str) -> tuple[int, int, np.ndarray, np.ndarray]:
    """(n, k, vlist_idx (m, dmax), vlist_len (m,)) from a code ``.npz``:
    row r of ``vlist_idx`` lists check r's neighbour columns, padded with n."""
    with np.load(path) as z:
        n, k = int(z["n"]), int(z["k"])
        idx = np.asarray(z["vlist_idx"], dtype=np.int64)
        ln = np.asarray(z["vlist_len"], dtype=np.int64)
    if idx.shape[0] != n - k or ln.shape != (n - k,):
        raise ValueError(f"{path}: {idx.shape[0]} checks for n={n}, k={k}")
    real = np.arange(idx.shape[1])[None, :] < ln[:, None]
    if np.any(idx[real] >= n) or np.any(idx[real] < 0) or np.any(idx[~real] != n):
        raise ValueError(f"{path}: Vlist columns out of range or badly padded")
    return n, k, idx, ln


def read_lift(path: str, idx: np.ndarray, n: int) -> np.ndarray:
    """(m, dmax) GF(256) coefficients of a lift ``.npz`` (``vlist_val``) on
    the padded Vlist ``idx``: nonzero on its support, 0 on its padding."""
    with np.load(path) as z:
        val = np.asarray(z["vlist_val"])
    support = idx < n
    if val.shape != idx.shape or val.dtype != np.uint8:
        raise ValueError(f"{path}: vlist_val is {val.dtype} {val.shape}, not uint8 {idx.shape}")
    if np.any(val[support] == 0) or np.any(val[~support] != 0):
        raise ValueError(f"{path}: a zero coefficient on the Vlist's support, or padding not 0")
    return val


def parity_check(n: int, idx: np.ndarray, values: np.ndarray | int = 1) -> np.ndarray:
    """(m, n) uint8 H from the padded Vlist: 1 on its support, or the
    coefficients ``values`` (m, dmax) of a lift."""
    h = np.zeros((idx.shape[0], n + 1), dtype=np.uint8)
    h[np.arange(idx.shape[0])[:, None], idx] = values
    return h[:, :n]


def gf2_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """X with ``a X = b`` over GF(2), ``a`` square; raises if ``a`` is singular."""
    m = a.shape[0]
    aug = np.concatenate([a, b], axis=1).astype(bool)
    for c in range(m):
        rows = c + np.flatnonzero(aug[c:, c])
        if rows.size == 0:
            raise ValueError(f"singular over GF(2) at column {c}")
        if rows[0] != c:
            aug[[c, rows[0]]] = aug[[rows[0], c]]
        hit = np.flatnonzero(aug[:, c])
        hit = hit[hit != c]
        aug[hit] ^= aug[c]
    return aug[:, m:].astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class GF256:
    """GF(2^8) from the frozen antilog table; log[0] is unused."""

    poly: int
    exp: np.ndarray  # (255,) alpha^i
    log: np.ndarray  # (256,)

    @classmethod
    def frozen(cls) -> "GF256":
        with open(os.path.join(HERE, "gf256.json")) as f:
            t = json.load(f)
        exp = np.asarray(t["exp"], dtype=np.int64)
        x = 1
        for i in range(255):  # the table must be the powers of x mod poly
            if exp[i] != x:
                raise ValueError(f"gf256.json: exp[{i}] is not x^{i} mod {t['poly']:#x}")
            x = (x << 1) ^ (t["poly"] if x & 0x80 else 0)
        log = np.zeros(256, dtype=np.int64)
        log[exp] = np.arange(255)
        return cls(t["poly"], exp, log)

    def mul(self, a, b) -> np.ndarray:
        a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
        out = self.exp[(self.log[a] + self.log[b]) % 255]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a) -> np.ndarray:
        return self.exp[(255 - self.log[np.asarray(a, dtype=np.int64)]) % 255]

    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        prod = self.mul(a[:, :, None], b[None, :, :])  # (r, i, c)
        return np.bitwise_xor.reduce(prod, axis=1)

    def inverse(self, a: np.ndarray) -> np.ndarray:
        m = a.shape[0]
        aug = np.concatenate([a, np.eye(m, dtype=np.int64)], axis=1).astype(np.int64)
        for c in range(m):
            rows = c + np.flatnonzero(aug[c:, c])
            if rows.size == 0:
                raise ValueError(f"singular over GF(256) at column {c}")
            if rows[0] != c:
                aug[[c, rows[0]]] = aug[[rows[0], c]]
            aug[c] = self.mul(self.inv(aug[c, c]), aug[c])
            hit = np.flatnonzero(aug[:, c])
            hit = hit[hit != c]  # the rows that hold column c; the others stay
            aug[hit] ^= self.mul(aug[hit, c][:, None], aug[c][None, :])
        return aug[:, m:]

    def tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(65536,) uint8 products, ``a * b`` at ``256 a + b``, and (256,)
        uint8 inverses (0 at 0)."""
        a = np.arange(256)
        mul = self.mul(a[:, None], a[None, :]).astype(np.uint8).reshape(-1)
        inv = np.where(a == 0, 0, self.inv(a)).astype(np.uint8)
        return mul, inv


def rs_parity(n: int, k: int, gf: GF256) -> np.ndarray:
    """(k, m) P of the systematic RS generator ``[I | P]``."""
    g = gf.exp[(np.arange(k)[:, None] * np.arange(n)[None, :]) % 255]
    gs = gf.matmul(gf.inverse(g[:, :k]), g)
    if not np.array_equal(gs[:, :k], np.eye(k, dtype=np.int64)):
        raise ArithmeticError("systematic RS generator is not [I | P]")
    return gs[:, k:]


def ldpc_parity_gf256(h: np.ndarray, k: int, gf: GF256) -> np.ndarray:
    """(k, m) P = (Hp^-1 Hs)^T of a GF(256) H = [Hs | Hp], so that
    ``parity = P^T source``. Column c of ``Hp^-1 Hs`` is the sum of
    ``Hp^-1[:, i] * Hs[i, c]`` over the few nonzeros of Hs's column c: one
    product a nonzero, never the (m, m, k) intermediate of a dense product."""
    m = h.shape[0]
    hp_inv = gf.inverse(h[:, k:].astype(np.int64))
    r, c = np.nonzero(h[:, :k])
    p = np.zeros((k, m), dtype=np.int64)
    np.bitwise_xor.at(p, c, gf.mul(hp_inv[:, r], h[r, c][None, :]).T)
    return p


def binary_image(p: np.ndarray, gf: GF256) -> np.ndarray:
    """(8m, 8k) 0/1 matrix of ``parity = P^T source`` on bytes: entry
    ``(8j + o, 8i + b)`` is bit o of ``P[i, j] * 2^b``."""
    k, m = p.shape
    prod = gf.mul(p[:, :, None], (1 << np.arange(8))[None, None, :]).astype(np.uint8)  # (i, j, b)
    bits = np.unpackbits(prod[..., None], axis=-1, bitorder="little")  # (i, j, b, o)
    return bits.transpose(1, 3, 0, 2).reshape(8 * m, 8 * k)


@dataclasses.dataclass
class Code:
    """A systematic code as the reference sees it: ``n``, ``k``, the parity
    map ``a`` over element bits, ``element_bits`` (1: a bit, 8: a byte), and
    for LDPC codes the padded Vlist (``vlist``, pad n) and either ``h``
    (binary) or ``h_nb``, the (m, n) GF(256) coefficients of a lift."""

    n: int
    k: int
    a: np.ndarray
    element_bits: int
    vlist: np.ndarray | None = None
    h: np.ndarray | None = None
    h_nb: np.ndarray | None = None

    @property
    def m(self) -> int:
        return self.n - self.k

    def codewords(self, source: torch.Tensor, *, block_bytes: int = 1 << 30) -> torch.Tensor:
        """(F, n, W) int32 codewords of (F, k, W) int32 source words, in
        blocks of frames that hold about ``block_bytes`` of unpacked bits."""
        f, k, w = source.shape
        dt = torch.float16 if source.device.type == "cuda" else torch.float32
        a = torch.from_numpy(self.a).to(source.device, dt)
        per_frame = k * w * 32 * (dt.itemsize + 1)
        step = max(1, block_bytes // per_frame)
        out = torch.empty((f, self.n, w), dtype=torch.int32, device=source.device)
        out[:, : self.k] = source
        for s in range(0, f, step):
            out[s : s + step, self.k :] = self._parity(source[s : s + step], a)
        return out

    def _parity(self, src: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        f, k, w = src.shape
        shifts = torch.arange(8, device=src.device, dtype=torch.uint8)
        bits = (src.contiguous().view(torch.uint8)[..., None] >> shifts) & 1  # (f, k, 4w, 8)
        if self.element_bits == 1:
            x = bits.reshape(f, k, 32 * w)
        else:
            x = bits.permute(0, 1, 3, 2).reshape(f, 8 * k, 4 * w)
        x = x.to(a.dtype)
        y = None
        for s in range(0, a.shape[1], EXACT_SUM):  # sums of at most EXACT_SUM, each exact
            part = torch.matmul(a[:, s : s + EXACT_SUM], x[:, s : s + EXACT_SUM]).to(torch.int32) & 1
            y = part if y is None else y ^ part
        if self.element_bits == 1:
            y = y.reshape(f, self.m, 4 * w, 8)
        else:
            y = y.reshape(f, self.m, 8, 4 * w).permute(0, 1, 3, 2)
        by = (y << shifts.to(torch.int32)).sum(dim=-1, dtype=torch.int32).to(torch.uint8)
        return by.contiguous().view(torch.int32)


def load(code: dict, root: str) -> Code:
    """The reference :class:`Code` of a configuration's ``code`` block:
    ``{"kind": "ldpc", "file": <frozen .npz under root>}``, with
    ``"gf_order": 256`` and ``"lift": {"file": <frozen lift .npz under root>}``
    for a GF(256) lift, or ``{"kind": "rs", "n": .., "k": ..}``."""
    if code["kind"] == "ldpc":
        n, k, idx, _ = read_vlist(os.path.join(root, code["file"]))
        if code.get("gf_order", 2) == 256:
            gf = GF256.frozen()
            h_nb = parity_check(n, idx, read_lift(os.path.join(root, code["lift"]["file"]), idx, n))
            p = ldpc_parity_gf256(h_nb, k, gf)
            return Code(n, k, binary_image(p, gf), 8, vlist=idx, h_nb=h_nb)
        h = parity_check(n, idx)
        a = gf2_solve(h[:, k:], h[:, :k])
        return Code(n, k, a, 1, vlist=idx, h=h)
    if code["kind"] == "rs":
        gf = GF256.frozen()
        p = rs_parity(code["n"], code["k"], gf)
        return Code(code["n"], code["k"], binary_image(p, gf), 8)
    raise ValueError(f"unknown code kind {code['kind']!r}")
