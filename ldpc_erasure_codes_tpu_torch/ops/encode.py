"""Systematic triangular encode of packed symbols: (B, k, W) -> (B, n, W).

Counterpart of ``ldpc_erasure_codes_tpu/ops/encode.py::encode_packed``
(:57-137) and of the TPU kernel ``ops/pallas_encode.py::encode_packed_vmem``
(:223-379), which compute the same codewords. :func:`encode_packed` launches
a CUDA kernel of ``csrc/encode.cu`` for CUDA tensors and runs
:func:`encode_packed_reference` for CPU tensors. The kernel's route is
chosen from the code's tables before launch: the slab route works the
parity rows level by level (:func:`encode_levels`; the plain version of
that order is :func:`encode_levels_reference`) wherever its block fits
(:func:`slab_words`; every shipped code), the per-warp route elsewhere.

Binary codes take int32 words. GF(256) codes take uint8 byte symbols
(W % 4 == 0), viewed as int32 words of four bytes for the arithmetic, and
parity row i is ``dinv_i * (sum src_val * src + sum par_val * parity_j)``
(ErasureCodes_NonBinaryLDPCSim.m:172-182), the function of
``encode_packed_vmem``'s GF(256) branch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.gf.tables import build_tables
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops._build import SMEM_LIMIT, round16 as _r16
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, device_arrays
from ldpc_erasure_codes_tpu_torch.utils import profiling


def _check(arrays: CodeArrays, source: torch.Tensor, gf_order: int) -> torch.Tensor:
    """Validate; returns the int32 word view of ``source``."""
    if gf_order not in (2, 256):
        raise ValueError(f"gf_order must be 2 or 256, got {gf_order}")
    if source.dim() != 3 or source.shape[2] < 1:
        raise ValueError(f"source must be (B, k, W) with W >= 1, got {tuple(source.shape)}")
    if source.device != arrays.device:
        raise ValueError(f"source on {source.device}, code tables on {arrays.device}")
    if source.shape[1] != arrays.n - arrays.m:
        raise ValueError(f"source has {source.shape[1]} symbols, the code k = "
                         f"{arrays.n - arrays.m}")
    if gf_order == 256:
        return as_words(source, "source")
    if source.dtype != torch.int32:
        raise TypeError(f"source must be torch.int32 words, got {source.dtype}")
    if not source.is_contiguous():
        raise ValueError("source must be contiguous")
    return source


def _bytes_out(words: torch.Tensor, gf_order: int) -> torch.Tensor:
    return words.view(torch.uint8) if gf_order == 256 else words


def encode_packed_reference(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Plain PyTorch encode, as encode.py:111-137: a gather-MAC over each
    parity row's source neighbours, then the back-substitution over parity
    rows in order (multiplies by coefficients only for GF(256))."""
    words = _check(arrays, source, gf_order)
    nb = gf_order == 256
    b, k, w = words.shape
    m = arrays.m
    src_p = torch.cat([words, words.new_zeros(b, 1, w)], dim=1)  # pad col k reads zero
    src_idx = arrays.enc_src_idx.long()
    t = words.new_zeros(b, m, w)
    for s in range(src_idx.shape[1]):
        term = src_p[:, src_idx[:, s], :]
        t ^= gf_mul_packed(term, arrays.enc_src_val[:, s, None]) if nb else term
    parity = words.new_zeros(b, m, w)
    par_val = arrays.enc_par_val.tolist()
    dinv = arrays.enc_diag_inv.tolist()
    for i, row in enumerate(arrays.enc_par_idx.tolist()):
        acc = t[:, i]
        for p, c in zip(row, par_val[i]):
            if p < m:
                acc = acc ^ (gf_mul_packed(parity[:, p], c) if nb else parity[:, p])
        parity[:, i] = gf_mul_packed(acc, dinv[i]) if nb else acc
    return _bytes_out(torch.cat([words, parity], dim=1), gf_order)


class EncodeLevels(NamedTuple):
    """The parity rows of a code in level order, for the encode's slab
    route (``csrc/encode.cu``). A row's level is 0 when it has no parity
    neighbour, else 1 + the highest level among its parity neighbours, so
    the rows of one level depend only on earlier levels. Parity row r is
    ``dinv_r * (sum sv * source + sum pv * parity)`` over GF(256), which
    the tables carry as ``sum (dinv_r sv) * source + sum (dinv_r pv) *
    parity``: the source sums of every row first, all at once, then the
    parity terms level by level (binary codes: every coefficient 1).

    order: (m,) int16, the rows sorted by level (stable: ascending within a
      level); every table below is in this order. level_off: (L + 1,)
      int32, level l holds positions [level_off[l], level_off[l + 1]).
    src: (m, ds) int16, each row's source neighbours (symbols < k), pad n
      (a symbol past the codeword, which reads zero); src_coef: (m, ds)
      uint8 their coefficients times the row's diagonal inverse, pad 0.
    par: (m, dp) int16, each row's parity neighbours as codeword symbols
      k + p, pad n; par_coef: (m, dp) uint8 likewise; par_len: (m,) int16
      their number.

    The kernel copies the tables into shared memory as they are (16-byte
    pieces), so the indices are 16-bit: codes of up to 32766 symbols.
    """

    order: torch.Tensor
    level_off: torch.Tensor
    src: torch.Tensor
    src_coef: torch.Tensor
    par: torch.Tensor
    par_coef: torch.Tensor
    par_len: torch.Tensor

    @property
    def levels(self) -> int:
        return self.level_off.shape[0] - 1


def row_levels(enc_par_idx: np.ndarray) -> np.ndarray:
    """Each parity row's level (:class:`EncodeLevels`) from its
    strictly-lower parity neighbours (m, pmax), pad m."""
    m = enc_par_idx.shape[0]
    lev = np.zeros(m, dtype=np.int64)
    for r, row in enumerate(enc_par_idx.tolist()):
        par = [p for p in row if p < m]
        if par:
            lev[r] = 1 + lev[par].max()
    return lev


def encode_levels(arrays: CodeArrays) -> EncodeLevels | None:
    """The code's parity rows in level order with their neighbour tables,
    built in NumPy from the encode tables (``CodeArrays.enc_levels``
    caches them on the tables' device). Codes of 32767 symbols or more
    get none (None): the per-warp route serves them."""
    if arrays.n >= 32767:
        return None
    tabs = {f: getattr(arrays, f).cpu().numpy() for f in (
        "enc_src_idx", "enc_src_val", "enc_par_idx", "enc_par_val", "enc_diag_inv")}
    m, n = arrays.m, arrays.n
    k = n - m
    lev = row_levels(tabs["enc_par_idx"])
    order = np.argsort(lev, kind="stable")
    counts = np.bincount(lev, minlength=int(lev.max(initial=0)) + 1)
    level_off = np.concatenate([[0], np.cumsum(counts)])
    mul = build_tables().mul
    dinv = tabs["enc_diag_inv"][order]

    def table(idx, val, real, base):
        """Each row's real entries first, as symbols ``base + idx``, pad n."""
        idx, val, real = idx[order], val[order], real[order]
        first = np.argsort(~real, axis=1, kind="stable")
        real = np.take_along_axis(real, first, axis=1)
        width = max(1, int(real.sum(axis=1).max(initial=0)))
        sym = np.where(real, base + np.take_along_axis(idx, first, axis=1), n)[:, :width]
        coef = np.where(real, mul[dinv[:, None], np.take_along_axis(val, first, axis=1)], 0)
        return sym, coef[:, :width], real.sum(axis=1)

    src, src_coef, _ = table(tabs["enc_src_idx"], tabs["enc_src_val"],
                             tabs["enc_src_idx"] < k, 0)
    par, par_coef, par_len = table(tabs["enc_par_idx"], tabs["enc_par_val"],
                                   tabs["enc_par_idx"] < m, k)
    dev = arrays.device

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    return EncodeLevels(
        order=t(order, np.int16), level_off=t(level_off, np.int32),
        src=t(src, np.int16), src_coef=t(src_coef, np.uint8),
        par=t(par, np.int16), par_coef=t(par_coef, np.uint8), par_len=t(par_len, np.int16))


def encode_levels_reference(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Plain PyTorch encode in the slab route's order: every row's
    (GF(256): coefficient-weighted) source sum at once, then level by
    level, all rows of a level at once, its parity terms over the codeword
    built so far (:func:`encode_levels`)."""
    words = _check(arrays, source, gf_order)
    nb = gf_order == 256
    lv = arrays.enc_levels
    b, k, w = words.shape
    m = arrays.m
    n = k + m
    cw = torch.cat([words, words.new_zeros(b, m + 1, w)], dim=1)  # symbol n stays zero

    def terms(acc, idx, coef):
        for j in range(idx.shape[1]):
            term = cw[:, idx[:, j].long(), :]
            acc ^= gf_mul_packed(term, coef[:, j, None]) if nb else term
        return acc

    rows = k + lv.order.long()
    cw[:, rows] = terms(words.new_zeros(b, m, w), lv.src, lv.src_coef)
    off = lv.level_off.tolist()
    for l0, l1 in zip(off[1:-1], off[2:]):
        cw[:, rows[l0:l1]] = terms(cw[:, rows[l0:l1]], lv.par[l0:l1], lv.par_coef[l0:l1])
    return _bytes_out(cw[:, :n].contiguous(), gf_order)


# Slab widths Wc of the slab route, in order of preference: the first whose
# block fits. Not 12: its 48-byte runs split 32-byte sectors of device
# memory between blocks (slower than 16 on the card, PERF.md), and no
# shipped code's slab fits 12 words where 16 does not.
SLAB_WORDS = (16, 8, 4)


def slab_smem(arrays: CodeArrays, wc: int, gf_order: int) -> int:
    """Shared memory of a slab-route block (csrc/encode.cu): the slab of n
    symbols and a zero symbol x Wc words; the source and parity tables, the
    parity counts and the rows as uint16; the level offsets (int32) and,
    GF(256), the coefficients."""
    lv = arrays.enc_levels
    n, m = arrays.n, arrays.m
    ds, dp = lv.src.shape[1], lv.par.shape[1]
    nb = _r16(m * ds) + _r16(m * dp) if gf_order == 256 else 0
    return (4 * (n + 1) * wc + _r16(2 * m * ds) + _r16(2 * m * dp) + 2 * _r16(2 * m)
            + _r16(4 * (lv.levels + 1)) + nb)


def slab_words(arrays: CodeArrays, w: int, gf_order: int = 2) -> int | None:
    """Wc of the slab route for W = ``w`` words: the first of
    :data:`SLAB_WORDS` no wider than W rounded up to 4 whose block fits in
    shared memory; None (the per-warp route) where even 4 words do not fit
    or the code has no level tables (32767 symbols or more)."""
    if arrays.enc_levels is None:
        return None
    fits = [wc for wc in SLAB_WORDS if wc <= max(4, -(-w // 4) * 4)
            and slab_smem(arrays, wc, gf_order) <= SMEM_LIMIT]
    return fits[0] if fits else None


def _count(gf_order: int) -> None:
    if gf_order == 256:
        encode_packed.launches_gf256 += 1
    else:
        encode_packed.launches += 1


def launch_slab(arrays: CodeArrays, words: torch.Tensor, gf_order: int, wc: int, *,
                compute: bool = True) -> torch.Tensor:
    """The slab route's kernel on CUDA int32 words (B, k, W) with Wc =
    ``wc`` words per block (one of :data:`SLAB_WORDS`, the block within
    shared memory); int32 codewords. ``compute=False`` runs the kernel's
    loads and stores alone (its parity rows are then garbage), to time
    them apart. Counts one launch of ``encode_packed`` (``launches`` or
    ``launches_gf256``)."""
    with profiling.span("encode.prep"):
        if (arrays.enc_levels is None or wc not in SLAB_WORDS
                or slab_smem(arrays, wc, gf_order) > SMEM_LIMIT):
            raise ValueError(f"encode slab of {wc} words: Wc must be one of {SLAB_WORDS} with "
                             f"the block's shared memory within {SMEM_LIMIT} bytes "
                             f"(n={arrays.n})")
        b, k, w = words.shape
        m = arrays.m
        lv = arrays.enc_levels
        out = torch.empty((b, k + m, w), dtype=torch.int32, device=words.device)
    with profiling.span("encode.launch"):
        rc = _build.library().ldpc_encode_slab_launch(
            words.data_ptr(), lv.order.data_ptr(), lv.level_off.data_ptr(), lv.src.data_ptr(),
            lv.src_coef.data_ptr(), lv.par.data_ptr(), lv.par_coef.data_ptr(),
            lv.par_len.data_ptr(), out.data_ptr(), b, k, m, lv.src.shape[1], lv.par.shape[1],
            lv.levels, w, wc, int(compute), int(gf_order == 256),
            torch.cuda.current_stream(words.device).cuda_stream,
        )
        _build.check(rc, "ldpc_encode_slab_launch")
    _count(gf_order)
    return out


def launch_warp(arrays: CodeArrays, words: torch.Tensor, gf_order: int) -> torch.Tensor:
    """The per-warp route's kernel on CUDA int32 words (B, k, W); int32
    codewords. Counts one launch of ``encode_packed``."""
    with profiling.span("encode.prep"):
        b, k, w = words.shape
        m, pmax = arrays.enc_par_idx.shape
        out = torch.empty((b, k + m, w), dtype=torch.int32, device=words.device)
    with profiling.span("encode.launch"):
        rc = _build.library().ldpc_encode_launch(
            words.data_ptr(), arrays.enc_src_idx.data_ptr(), arrays.enc_par_idx.data_ptr(),
            arrays.enc_src_val.data_ptr(), arrays.enc_par_val.data_ptr(),
            arrays.enc_diag_inv.data_ptr(), out.data_ptr(), b, k, m, w,
            arrays.enc_src_idx.shape[1], pmax, int(gf_order == 256),
            torch.cuda.current_stream(words.device).cuda_stream,
        )
        _build.check(rc, "ldpc_encode_launch")
    _count(gf_order)
    return out


def encode_packed(
    arrays: CodeArrays, source: torch.Tensor, *, gf_order: int = 2
) -> torch.Tensor:
    """Systematic encode of ``source`` -> (B, n, W).

    ``source`` is (B, k, W) int32 words for ``gf_order=2`` and (B, k, W)
    uint8 bytes (W % 4 == 0) for ``gf_order=256``; the codewords come back
    in the same type. CPU tensors take :func:`encode_packed_reference`;
    CUDA tensors launch a kernel (or raise): the slab route where
    :func:`slab_words` gives a width, else the per-warp route.
    ``encode_packed.launches`` counts binary launches of either,
    ``encode_packed.launches_gf256`` GF(256) ones.
    """
    with profiling.span("encode.packed", device=source.device):
        words = _check(arrays, source, gf_order)
        if words.device.type == "cpu":
            with profiling.span("encode.launch"):  # the plain version
                return encode_packed_reference(arrays, source, gf_order=gf_order)
        if words.device.type != "cuda":
            raise ValueError(f"unsupported device {words.device}")
        wc = slab_words(arrays, words.shape[2], gf_order)
        if wc is None:
            out = launch_warp(arrays, words, gf_order)
        else:
            out = launch_slab(arrays, words, gf_order, wc)
        return _bytes_out(out, gf_order)


encode_packed.launches = 0
encode_packed.launches_gf256 = 0


def random_words(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform random int32 words (all 32 bits) from ``generator``: a
    binary source for :func:`encode_packed`."""
    return torch.randint(
        -(2**31), 2**31, shape, dtype=torch.int32, generator=generator, device=device
    )


def random_bytes(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform random uint8 bytes from ``generator``, drawn as int32 words
    (the last dimension must be a multiple of 4): a GF(256) source."""
    *lead, wb = shape
    return random_words((*lead, wb // 4), generator, device).view(torch.uint8)


def scalar_words(symbols: torch.Tensor, gf_order: int) -> torch.Tensor:
    """Scalar uint8 symbols (..., n) as one-symbol packed frames
    (..., n, 1) int32: the symbol itself as a word (binary), or its byte
    zero-padded to four (GF(256), byte 0 of the word)."""
    if symbols.dtype != torch.uint8:
        raise TypeError(f"scalar symbols must be torch.uint8, got {symbols.dtype}")
    if gf_order == 256:
        return torch.nn.functional.pad(symbols[..., None], (0, 3)).contiguous().view(torch.int32)
    return symbols.to(torch.int32)[..., None].contiguous()


def from_scalar_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`scalar_words`: the low byte of each one-word
    symbol, (..., n, 1) int32 -> (..., n) uint8."""
    return (words[..., 0] & 0xFF).to(torch.uint8)


def _encode_scalar(arrays: CodeArrays, source: torch.Tensor, gf_order: int) -> torch.Tensor:
    lead = source.shape[:-1]
    words = scalar_words(source.reshape(-1, source.shape[-1]), gf_order)
    if gf_order == 256:
        cw = encode_packed(arrays, words.view(torch.uint8), gf_order=256).view(torch.int32)
    else:
        cw = encode_packed(arrays, words)
    cw = from_scalar_words(cw)
    return cw.reshape(*lead, cw.shape[-1])


def encode(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """Binary systematic encode of scalar symbols: (..., k) uint8 -> (..., n)
    uint8, as ``ops/encode.py::encode`` (:26-32). A systematic codeword is
    unique, so the bits ride through the triangular encoder as one-word
    symbols; the parity is taken mod 2 (the low bit), as JAX's mod-2
    product is, and the source part is returned as given."""
    cw = _encode_scalar(arrays, source, 2)
    k = source.shape[-1]
    return torch.cat([source, cw[..., k:] & 1], dim=-1)


def encode_nb(arrays: CodeArrays, source: torch.Tensor) -> torch.Tensor:
    """GF(256) systematic encode of scalar byte symbols: (..., k) uint8 ->
    (..., n) uint8, as ``ops/encode.py::encode_nb`` (:35-43). Each byte
    rides through the triangular encoder as a zero-padded four-byte symbol
    (the GF(256) word mode, whose other three bytes stay zero)."""
    return _encode_scalar(arrays, source, 256)


def encode_wide(arrays: CodeArrays, source_bits: torch.Tensor) -> torch.Tensor:
    """Bit-plane binary encode: (..., S, k) uint8 bits -> (..., S, n), the
    symbol-width axis S riding as batch (``ops/encode.py::encode_wide``
    :46-54): :func:`encode`."""
    return encode(arrays, source_bits)


def make_packed_encoder(code, device: torch.device | str | None = None):
    """The packed binary encoder of one code (``ops/encode.py::
    make_packed_encoder`` :140-188): returns ``fn(source (B, k, W) int32)
    -> (B, n, W)``, :func:`encode_packed` on the code's tables on
    ``device`` (the CUDA card unless the caller names another). On the
    card its slab route already works the parity rows level by level
    (:func:`encode_levels`), the schedule JAX bakes into its closure.
    Binary codes only, as JAX's closure sums without coefficients."""
    if code.gf_order != 2:
        raise ValueError(f"make_packed_encoder takes binary codes, got GF({code.gf_order})")
    arrays = device_arrays(code, device)

    def encode_fn(source: torch.Tensor) -> torch.Tensor:
        return encode_packed(arrays, source)

    return encode_fn


def encode_scan(arrays: CodeArrays, source: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The reference's sequential binary encoder (``ops/encode.py::
    encode_scan`` :191-219), a cross-check: (..., k) uint8 bits -> (..., n)
    uint8. Parity row i's last Vlist neighbour is its diagonal symbol
    k + i (rows are ascending and in triangle form); it takes the sum mod 2
    of the row's other neighbours in the codeword built so far, one row at
    a time."""
    idx = arrays.vlist_idx.long()
    last = arrays.vlist_len.long() - 1
    # Drop the diagonal and the pad: column n reads zero.
    nbrs = torch.where(torch.arange(arrays.dmax, device=idx.device) < last[:, None], idx, n)
    diag = idx.gather(1, last[:, None])[:, 0].tolist()
    cw = source.new_zeros((*source.shape[:-1], n + 1), dtype=torch.int32)
    cw[..., :k] = source
    for i, col in enumerate(diag):
        cw[..., col] = cw[..., nbrs[i]].sum(dim=-1) & 1
    return cw[..., :n].to(torch.uint8)
