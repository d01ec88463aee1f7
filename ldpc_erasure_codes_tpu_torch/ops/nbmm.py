"""GF(2) and GF(256) products of matrices with wide rows
(``ldpc_erasure_codes_tpu/ops/pallas_nbmm.py``).

Counterparts of the TPU kernels ``f2_matvec_wide`` (:342-404),
``f2_matmul_batched`` (:407-462) and ``f2_apply_scatter`` (:465-553), which
share ``_f2_matmul_body`` (:314-338). The TPU kernels take an unpacked int8
0/1 matrix for the MXU and byte-viewed values; the port keeps the matrices
packed, (E, ceil(K/32)) int32 words with bit ``j`` of a row in bit
``j & 31`` of word ``j >> 5`` (H as ``CodeArrays.h_words``, the transforms
straight from the eliminated cube), and the values as (B, K, W) int32 words.
A GF(2) product acts on each bit position alone, so the bits equal the
byte-plane MXU form's. All three launch ``csrc/f2mm.cu`` for CUDA tensors
and run the plain versions for CPU tensors. Bits of a matrix row at or past
K are ignored. Their routes, chosen from the shapes before launch:

* ``f2_matvec_wide``: a sparse H (an LDPC code's) the list route, which
  sums each row's listed symbols out of a shared-memory slab
  (:func:`f2_matrix_rows`, cached as ``CodeArrays.h_rows``); a dense
  matrix the bit scan;
* ``f2_apply_scatter``: only the rows that it places, each over the list of
  its transform row's set columns, made in the kernel, summed out of a
  slab; the copy of the values in the same kernel;
* ``f2_matmul_batched``: the apply's list and sum over every row, written
  in order (its own kernel) where its slab fits
  (:func:`f2_matmul_route`), else the bit scan.

The GF(256) counterparts of the TPU kernels ``gf_matvec_wide`` (:132-213),
``gf_matmul_batched`` (:241-311) and ``gf_apply_scatter`` (:556-651)
contract an int8 bit image of a byte matrix on the MXU. Here the matrix
stays bytes and the payloads are uint8 (B, K, W) bytes (W % 4 == 0),
multiplied four bytes to an int32 word. All three launch ``csrc/gfmm.cu``
for CUDA tensors and run the plain versions for CPU tensors:

* ``gf_matvec_wide``: the dense route (the RS H, tiled by
  :func:`matrix_tiles`): a thread per payload word tables its word's
  nibble products and keeps a tile's output rows in registers; the list
  route (a sparse LDPC Vlist, :func:`matrix_rows`): a warp per output row,
  Horner over the coefficient bits;
* ``gf_apply_scatter``: the dense route's nibble products over each
  frame's placed rows, in tiles of :func:`gf_apply_rows` rows, with the
  copy of the values in the same kernel;
* ``gf_matmul_batched`` (the apply without the placement): the apply's
  nibble products over every row, in tiles of :func:`gf_apply_rows` rows
  in order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import _xtime_packed, as_words, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops._build import SMEM_LIMIT, round16 as _r16
from ldpc_erasure_codes_tpu_torch.ops.arrays import pack_bits, unpack_bits

# Words per chunk of the plain product: bounds its unpacked float operand
# to (B, K, 32 * _PLAIN_WORDS), as ge.py:417 bounds its int8 temp.
_PLAIN_WORDS = 16


def _check(rhs: torch.Tensor, mat: torch.Tensor, per_frame: bool) -> None:
    if rhs.dtype != torch.int32 or mat.dtype != torch.int32:
        raise TypeError(f"rhs and matrix must be torch.int32, got {rhs.dtype}, {mat.dtype}")
    if rhs.dim() != 3 or rhs.shape[2] < 1:
        raise ValueError(f"rhs must be (B, K, W) with W >= 1, got {tuple(rhs.shape)}")
    b, k, _ = rhs.shape
    kw = -(-k // 32)
    if mat.dim() != (3 if per_frame else 2):
        raise ValueError(f"matrix must be {'(B, E, KW)' if per_frame else '(m, KW)'}, "
                         f"got {tuple(mat.shape)}")
    want = (b, mat.shape[1], kw) if per_frame else (mat.shape[0], kw)
    if tuple(mat.shape) != want:
        raise ValueError(f"matrix shape {tuple(mat.shape)} != {want} for rhs {tuple(rhs.shape)}")
    if rhs.device != mat.device:
        raise ValueError(f"rhs on {rhs.device}, matrix on {mat.device}")
    if not (rhs.is_contiguous() and mat.is_contiguous()):
        raise ValueError("rhs and matrix must be contiguous")


def _product_reference(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x[b] = M_b . rhs[b] over GF(2) as a bit-plane product mod 2, chunked
    over W (ge.py:416-429). ``mat`` is (B or 1, E, KW); counts stay below
    2^24, so float32 sums are exact."""
    b, k, w = rhs.shape
    m01 = unpack_bits(mat)[..., :k].float()  # (B|1, E, K)
    chunks = []
    for off in range(0, w, _PLAIN_WORDS):
        wc = min(_PLAIN_WORDS, w - off)
        bits = unpack_bits(rhs[:, :, off : off + wc]).float()  # (B, K, 32wc)
        par = torch.matmul(m01, bits).to(torch.int32) & 1  # (B, E, 32wc)
        chunks.append(pack_bits(par))
    return torch.cat(chunks, dim=2)


def f2_matvec_wide_reference(values: torch.Tensor, h_words: torch.Tensor) -> torch.Tensor:
    _check(values, h_words, per_frame=False)
    return _product_reference(h_words[None], values)


def f2_matmul_batched_reference(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    _check(rhs, t_words, per_frame=True)
    return _product_reference(t_words, rhs)


def f2_apply_scatter_reference(
    values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    _check_apply(values, rhs, t_words, idx)
    x = _product_reference(t_words, rhs)
    out = values.clone()
    keep = (idx >= 0) & (idx < values.shape[1])
    frames = torch.arange(values.shape[0], device=values.device)[:, None].expand_as(idx)
    f, t = frames[keep], idx[keep].long()
    out[f, t] ^= x[keep]
    return out


def _listed_sums(rhs: torch.Tensor, t_words: torch.Tensor, frames: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Row ``rows[p]`` of T_``frames[p]`` times rhs, (P, W): the row's set
    columns below K listed (padded with K, which reads a zero row), then a
    loop over the list slots, each a gather of one rhs row per listed row
    (the kernels' step 4, ``csrc/f2mm.cu``)."""
    b, k, w = rhs.shape
    if not len(frames):
        return rhs.new_zeros(0, w)
    bits = unpack_bits(t_words[frames, rows])[:, :k] != 0  # (P, K)
    length = bits.sum(dim=1)
    d = max(1, int(length.max()))
    order = torch.argsort((~bits).to(torch.uint8), dim=1, stable=True)[:, :d]  # set bits first
    cols = torch.where(torch.arange(d, device=rhs.device)[None, :] < length[:, None], order, k)
    padded = torch.cat([rhs, rhs.new_zeros(b, 1, w)], dim=1)  # column K reads zero
    acc = rhs.new_zeros(len(frames), w)
    for s in range(d):
        acc ^= padded[frames, cols[:, s]]
    return acc


def f2_matmul_rows_reference(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch product in the order of ``f2_matmul_batched``'s list
    route (``csrc/f2mm.cu``, ``f2_matmul_rows_kernel``): every row of T_b, in
    order, as the sum of the rhs rows its set columns list (a loop over
    the list slots, as :func:`f2_apply_rows_reference`); a row with no set
    column gives zeros. Equal to :func:`f2_matmul_batched_reference`."""
    _check(rhs, t_words, per_frame=True)
    b, e = t_words.shape[:2]
    frames, rows = torch.ones((b, e), dtype=torch.bool, device=rhs.device).nonzero(as_tuple=True)
    return _listed_sums(rhs, t_words, frames, rows).view(b, e, rhs.shape[2])


def f2_apply_rows_reference(
    values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch apply in the kernel's order (``csrc/f2mm.cu``): the
    placed rows (target in [0, n)) listed first, the values copied, then
    each placed row's sum of the rhs rows its transform row lists (a loop
    over the list slots, as :func:`f2_matvec_rows_reference`) XORed into
    its target. Equal to :func:`f2_apply_scatter_reference`."""
    _check_apply(values, rhs, t_words, idx)
    out = values.clone()
    frames, rows = ((idx >= 0) & (idx < values.shape[1])).nonzero(as_tuple=True)
    out[frames, idx[frames, rows].long()] ^= _listed_sums(rhs, t_words, frames, rows)
    return out


def _check_apply(values, rhs, t_words, idx) -> None:
    _check(rhs, t_words, per_frame=True)
    b, _, w = rhs.shape
    if values.dtype != torch.int32 or values.dim() != 3 or values.shape[::2] != (b, w):
        raise ValueError(f"values {tuple(values.shape)} {values.dtype} vs rhs {tuple(rhs.shape)}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, t_words.shape[1]):
        raise ValueError(f"idx must be ({b}, {t_words.shape[1]}) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if not (values.device == idx.device == rhs.device):
        raise ValueError("values, idx and rhs must be on one device")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("values and idx must be contiguous")


def _stream(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


# The list route of f2_matvec_wide serves matrices whose heaviest row holds
# at most one in F2_LIST_SPARSITY of the K columns (an LDPC H: 14 of 2040
# at (2040,1530), 7 of 2000 and of 4000 at (2000,1000) and (4000,2000));
# denser ones (a random dense matrix: half its bits) take the bit scan.
F2_LIST_SPARSITY = 8
# The list route's slab widths Wc, in order of preference (the fastest
# first, by chip_smoke.py's sweep; PERF.md): the first whose block fits.
F2_SLAB_WORDS = (16, 8, 4)


def f2_matrix_rows(h_words: torch.Tensor, k: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The set columns of each row of a packed GF(2) matrix (m, KW) int32,
    for the list route of :func:`f2_matvec_wide`: (idx (m, d) int32, each
    row's columns below ``k`` in ascending order, padded with k; len (m,)
    int32, their number), d the largest row weight (at least 1). ``k``
    defaults to 32 * KW; bits at or past it are dropped. Built once per
    matrix (``CodeArrays.h_rows`` caches H's)."""
    if h_words.dtype != torch.int32 or h_words.dim() != 2:
        raise ValueError(f"matrix must be (m, KW) int32 words, got {tuple(h_words.shape)} "
                         f"{h_words.dtype}")
    m, kw = h_words.shape
    k = 32 * kw if k is None else k
    if not 0 <= k <= 32 * kw:
        raise ValueError(f"k={k} outside the matrix's {32 * kw} columns")
    bits = unpack_bits(h_words)[:, :k] != 0  # (m, k)
    length = bits.sum(dim=1)
    d = max(1, int(length.max())) if m and k else 1
    if k == 0:
        return (torch.zeros((m, 1), dtype=torch.int32, device=h_words.device),
                length.to(torch.int32))
    order = torch.argsort((~bits).to(torch.uint8), dim=1, stable=True)[:, :d]  # set bits first
    keep = torch.arange(order.shape[1], device=h_words.device)[None, :] < length[:, None]
    idx = torch.where(keep, order, k)
    return idx.to(torch.int32).contiguous(), length.to(torch.int32).contiguous()


def f2_matvec_rows_reference(values: torch.Tensor, idx: torch.Tensor,
                             length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch list route: out[b, e] = XOR of values[b, idx[e, j]]
    over j < length[e] (entries outside [0, K) add nothing), a loop over
    the list slots, each a gather of one row per output row."""
    _check_f2_rows(values, idx, length)
    b, k, w = values.shape
    d = idx.shape[1]
    vp = torch.cat([values, values.new_zeros(b, 1, w)], dim=1)  # index K reads zero
    live = ((torch.arange(d, device=idx.device)[None, :] < length[:, None].long())
            & (idx >= 0) & (idx < k))
    ix = torch.where(live, idx, k).long()
    out = values.new_zeros(b, idx.shape[0], w)
    for s in range(d):
        out ^= vp[:, ix[:, s], :]
    return out


def _check_f2_rows(values: torch.Tensor, idx: torch.Tensor, length: torch.Tensor) -> None:
    if values.dtype != torch.int32 or values.dim() != 3 or values.shape[2] < 1:
        raise ValueError(f"values must be (B, K, W) int32 with W >= 1, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] < 1:
        raise ValueError(f"row lists must be (m, d) int32 with d >= 1, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if length.dtype != torch.int32 or tuple(length.shape) != idx.shape[:1]:
        raise ValueError(f"row lengths must be ({idx.shape[0]},) int32, got "
                         f"{tuple(length.shape)} {length.dtype}")
    if not (values.device == idx.device == length.device):
        raise ValueError("values and row lists must be on one device")
    if not (values.is_contiguous() and idx.is_contiguous() and length.is_contiguous()):
        raise ValueError("values and row lists must be contiguous")


def f2_rows_smem(k: int, m: int, d: int, wc: int) -> int:
    """Shared memory of a list-route block (csrc/f2mm.cu): the slab of K
    rows and a zero row of Wc words, the (m, d) lists and the lengths as
    uint16."""
    return 4 * (k + 1) * wc + _r16(2 * m * d) + _r16(2 * m)


def f2_slab_words(idx: torch.Tensor, k: int, w: int) -> int | None:
    """Wc of the list route for row lists ``idx`` (m, d) over K = ``k``
    symbols of W = ``w`` words (:func:`f2_rows_slab_words` of its shape)."""
    return f2_rows_slab_words(k, *idx.shape, w)


def f2_rows_slab_words(k: int, m: int, d: int, w: int) -> int | None:
    """Wc of the list route for m row lists of width d over K = ``k``
    symbols of W = ``w`` words: the first of :data:`F2_SLAB_WORDS` no
    wider than W rounded up to 4 whose block fits; None (no slab: the
    caller's other route) for lists wider than K // :data:`F2_LIST_SPARSITY`,
    K >= 65535, or a slab that does not fit even at 4 words."""
    if d > k // F2_LIST_SPARSITY or k >= 65535:
        return None
    fits = [wc for wc in F2_SLAB_WORDS if wc <= max(4, -(-w // 4) * 4)
            and f2_rows_smem(k, m, d, wc) <= SMEM_LIMIT]
    return fits[0] if fits else None


def launch_rows(values: torch.Tensor, idx: torch.Tensor, length: torch.Tensor,
                wc: int, counter=None) -> torch.Tensor:
    """The list route's kernel on CUDA tensors with Wc = ``wc`` words per
    block (one of :data:`F2_SLAB_WORDS`, the block within shared memory).
    Counts one launch on ``counter`` (a wrapper with a ``launches``
    attribute; default ``f2_matvec_wide``; ``synd.syndrome_from_topo``
    passes itself)."""
    _check_f2_rows(values, idx, length)
    b, k, w = values.shape
    m, d = idx.shape
    if wc not in F2_SLAB_WORDS or f2_rows_smem(k, m, d, wc) > SMEM_LIMIT or k >= 65535:
        raise ValueError(f"list-route slab of {wc} words: Wc must be one of {F2_SLAB_WORDS} "
                         f"with the block's shared memory within {SMEM_LIMIT} bytes (K={k}, "
                         f"lists ({m}, {d}))")
    out = torch.empty((b, m, w), dtype=torch.int32, device=values.device)
    rc = _build.library().ldpc_f2_matvec_rows_launch(
        values.data_ptr(), idx.data_ptr(), length.data_ptr(), out.data_ptr(), b, k, m, d, w, wc,
        _stream(values),
    )
    _build.check(rc, "ldpc_f2_matvec_rows_launch")
    (counter or f2_matvec_wide).launches += 1
    return out


def f2_matvec_wide(values: torch.Tensor, h_words: torch.Tensor, *,
                   rows: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """rhs[b] = H . values[b] over GF(2): (B, n, W) int32 -> (B, m, W).

    ``h_words`` is (m, ceil(n/32)), ``CodeArrays.h_words``. Erased slots of
    ``values`` hold zero, so this is the syndrome of the known symbols.
    CPU tensors take the plain version; CUDA tensors launch a kernel (or
    raise):

    * the list route where :func:`f2_slab_words` gives a slab width (rows
      of at most K // :data:`F2_LIST_SPARSITY` set columns, as an LDPC H's):
      each row's listed symbols summed out of a shared-memory slab;
      ``rows`` passes :func:`f2_matrix_rows` of ``h_words`` over n columns,
      built once (``CodeArrays.h_rows``; else they are built here, on
      every call);
    * the bit-scan route otherwise (a dense matrix).

    ``f2_matvec_wide.launches`` counts launches of either.
    """
    _check(values, h_words, per_frame=False)
    if values.device.type == "cpu":
        return f2_matvec_wide_reference(values, h_words)
    b, n, w = values.shape
    m = h_words.shape[0]
    if rows is None:
        rows = f2_matrix_rows(h_words, n)
    if rows[0].shape[0] != m:
        raise ValueError(f"row lists of {rows[0].shape[0]} rows for a matrix of {m}")
    wc = f2_slab_words(rows[0], n, w)
    if wc is not None:
        return launch_rows(values, *rows, wc)
    return launch_scan(values, h_words)


def launch_scan(values: torch.Tensor, h_words: torch.Tensor) -> torch.Tensor:
    """The bit-scan route's kernel on CUDA tensors (any packed matrix).
    Counts one launch of ``f2_matvec_wide``."""
    _check(values, h_words, per_frame=False)
    b, n, w = values.shape
    m, kw = h_words.shape
    out = torch.empty((b, m, w), dtype=torch.int32, device=values.device)
    rc = _build.library().ldpc_f2_matvec_launch(
        values.data_ptr(), h_words.data_ptr(), out.data_ptr(), b, n, kw, m, w, _stream(values)
    )
    _build.check(rc, "ldpc_f2_matvec_launch")
    f2_matvec_wide.launches += 1
    return out


# The apply's slab widths Wc, in order of preference (the fastest first, by
# chip_smoke.py's sweep; PERF.md): the first whose block fits.
F2_APPLY_WORDS = (16, 8, 4)
# Warps of a block of the apply or of f2_matmul_batched's list route, each
# with its own list of up to K columns.
F2_APPLY_WARPS = 16
# The slab widths Wc of f2_matmul_batched's list route, in order of
# preference (the fastest first, by chip_smoke.py's sweep; PERF.md): the
# first whose block fits.
F2_MATMUL_WORDS = (32, 16, 8, 4)
# The bit scan's staging budget (csrc/f2mm.cu kSmemBudget): K rows of at
# least one word each must fit it.
F2_SCAN_SMEM = 128 * 1024


def f2_matmul_smem(k: int, wc: int) -> int:
    """Shared memory of a block of ``f2_matmul_batched``'s list route
    (``f2_matmul_rows_kernel``, csrc/f2mm.cu): the slab of K rows of Wc
    words and a uint16 list of K columns per warp."""
    return 4 * k * wc + _r16(2 * F2_APPLY_WARPS * k)


def f2_matmul_slab_words(k: int, w: int) -> int | None:
    """Wc of ``f2_matmul_batched``'s list route for K = ``k`` rhs rows of W
    = ``w`` words: the first of :data:`F2_MATMUL_WORDS` no wider than W
    rounded up to 4 whose block fits; None where none fits (K >= 65535, or
    a slab too large even at 4 words)."""
    if k >= 65535:
        return None
    fits = [wc for wc in F2_MATMUL_WORDS if wc <= max(4, -(-w // 4) * 4)
            and f2_matmul_smem(k, wc) <= SMEM_LIMIT]
    return fits[0] if fits else None


def f2_matmul_route(k: int, w: int) -> str | None:
    """The route ``f2_matmul_batched`` takes for K = ``k`` rhs rows of W =
    ``w`` words: "list" (every row listed and summed out of a slab, at
    :func:`f2_matmul_slab_words`) where its block fits, else "scan" (the
    bit scan) where K rows of one word fit :data:`F2_SCAN_SMEM`; None where
    neither fits."""
    if f2_matmul_slab_words(k, w) is not None:
        return "list"
    return "scan" if 4 * k <= F2_SCAN_SMEM else None


def launch_matmul_rows(rhs: torch.Tensor, t_words: torch.Tensor, wc: int) -> torch.Tensor:
    """The list route's kernel on CUDA tensors with Wc = ``wc`` words per
    block (one of :data:`F2_MATMUL_WORDS`, the block within shared memory).
    Counts one launch of ``f2_matmul_batched``."""
    _check(rhs, t_words, per_frame=True)
    b, k, w = rhs.shape
    _, e, kw = t_words.shape
    if wc not in F2_MATMUL_WORDS or f2_matmul_smem(k, wc) > SMEM_LIMIT or k >= 65535:
        raise ValueError(f"rows slab of {wc} words: Wc must be one of {F2_MATMUL_WORDS} with "
                         f"the block's shared memory within {SMEM_LIMIT} bytes (K={k})")
    out = torch.empty((b, e, w), dtype=torch.int32, device=rhs.device)
    rc = _build.library().ldpc_f2_matmul_rows_launch(
        rhs.data_ptr(), t_words.data_ptr(), out.data_ptr(), b, k, kw, e, w, wc, _stream(rhs)
    )
    _build.check(rc, "ldpc_f2_matmul_rows_launch")
    f2_matmul_batched.launches += 1
    return out


def launch_matmul_scan(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    """The bit-scan route's kernel on CUDA tensors (K rows of one word
    within :data:`F2_SCAN_SMEM`). Counts one launch of
    ``f2_matmul_batched``."""
    _check(rhs, t_words, per_frame=True)
    b, k, w = rhs.shape
    _, e, kw = t_words.shape
    if 4 * k > F2_SCAN_SMEM:
        raise ValueError(f"bit scan: K={k} rows of one word exceed {F2_SCAN_SMEM} bytes")
    out = torch.empty((b, e, w), dtype=torch.int32, device=rhs.device)
    rc = _build.library().ldpc_f2_matmul_launch(
        rhs.data_ptr(), t_words.data_ptr(), out.data_ptr(), b, k, kw, e, w, _stream(rhs)
    )
    _build.check(rc, "ldpc_f2_matmul_launch")
    f2_matmul_batched.launches += 1
    return out


def f2_matmul_batched(rhs: torch.Tensor, t_words: torch.Tensor) -> torch.Tensor:
    """x[b] = T_b . rhs[b] over GF(2): rhs (B, K, W), T (B, E, ceil(K/32))
    -> (B, E, W) int32, the solved rows without placement.

    CPU tensors take the plain version; CUDA tensors launch a kernel (or
    raise), by :func:`f2_matmul_route`:

    * the list route where its block fits (K < 65535 and the slab of
      :func:`f2_matmul_slab_words`): every row's set columns listed and
      its rhs rows summed out of a shared-memory slab, the rows written in
      order;
    * the bit scan otherwise, while K rows of one word fit its staging.

    ``f2_matmul_batched.launches`` counts launches of either.
    """
    _check(rhs, t_words, per_frame=True)
    if rhs.device.type == "cpu":
        return f2_matmul_batched_reference(rhs, t_words)
    k, w = rhs.shape[1], rhs.shape[2]
    route = f2_matmul_route(k, w)
    if route == "list":
        return launch_matmul_rows(rhs, t_words, f2_matmul_slab_words(k, w))
    if route == "scan":
        return launch_matmul_scan(rhs, t_words)
    raise ValueError(f"f2_matmul_batched: no route fits K={k} (list route: K < 65535 and a "
                     f"slab within {SMEM_LIMIT} bytes; bit scan: 4 K <= {F2_SCAN_SMEM})")


def f2_apply_smem(k: int, e: int, n: int, wc: int) -> int:
    """Shared memory of an apply block (csrc/f2mm.cu): the slab of K rows
    of Wc words, a uint16 list of K columns per warp, the placed rows, a
    bit per symbol of the n, and the count."""
    return f2_matmul_smem(k, wc) + _r16(4 * e) + _r16(4 * -(-n // 32)) + 16


def f2_apply_slab_words(k: int, e: int, n: int, w: int) -> int | None:
    """Wc of the apply for K = ``k`` rhs rows, E = ``e`` transform rows, n
    symbols and W = ``w`` words: the first of :data:`F2_APPLY_WORDS` no wider than W
    rounded up to 4 whose block fits; None where none fits (K >= 65535, or
    a slab too large even at 4 words)."""
    if k >= 65535:
        return None
    fits = [wc for wc in F2_APPLY_WORDS if wc <= max(4, -(-w // 4) * 4)
            and f2_apply_smem(k, e, n, wc) <= SMEM_LIMIT]
    return fits[0] if fits else None


def launch_apply(values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor,
                 idx: torch.Tensor, wc: int) -> torch.Tensor:
    """The apply's kernel on CUDA tensors with Wc = ``wc`` words per block
    (one of :data:`F2_APPLY_WORDS`, the block within shared memory). Counts
    one launch of ``f2_apply_scatter``."""
    _check_apply(values, rhs, t_words, idx)
    b, k, w = rhs.shape
    _, e, kw = t_words.shape
    n = values.shape[1]
    if wc not in F2_APPLY_WORDS or f2_apply_smem(k, e, n, wc) > SMEM_LIMIT or k >= 65535:
        raise ValueError(f"apply slab of {wc} words: Wc must be one of {F2_APPLY_WORDS} with "
                         f"the block's shared memory within {SMEM_LIMIT} bytes (K={k}, E={e}, "
                         f"n={n})")
    out = torch.empty_like(values)
    rc = _build.library().ldpc_f2_apply_rows_launch(
        values.data_ptr(), rhs.data_ptr(), t_words.data_ptr(), idx.data_ptr(), out.data_ptr(),
        b, k, kw, e, w, n, wc, _stream(values),
    )
    _build.check(rc, "ldpc_f2_apply_rows_launch")
    f2_apply_scatter.launches += 1
    return out


def f2_apply_scatter(
    values: torch.Tensor, rhs: torch.Tensor, t_words: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``values`` with row e of T_b . rhs[b] XORed into symbol idx[b, e]:
    the solved rows placed in the erased slots (which hold zero).

    values (B, n, W), rhs (B, K, W), T (B, E, ceil(K/32)) int32, idx (B, E)
    int32. Targets outside [0, n) are dropped (the TPU kernel's dump rows,
    cut off at ge.py:412-414); targets in range must be distinct within a
    frame. Returns a new (B, n, W) tensor. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise) at the slab width of
    :func:`f2_apply_slab_words`: only the placed rows are computed, each
    over its list of set columns, and the copy of the values is the
    kernel's own. ``f2_apply_scatter.launches`` counts kernel launches.
    """
    _check_apply(values, rhs, t_words, idx)
    if values.device.type == "cpu":
        return f2_apply_scatter_reference(values, rhs, t_words, idx)
    k, e, n = rhs.shape[1], t_words.shape[1], values.shape[1]
    wc = f2_apply_slab_words(k, e, n, rhs.shape[2])
    if wc is None:
        raise ValueError(f"apply: no slab width in {F2_APPLY_WORDS} fits shared memory "
                         f"({SMEM_LIMIT} bytes) at K={k}, E={e}, n={n}")
    return launch_apply(values, rhs, t_words, idx, wc)


f2_matvec_wide.launches = 0
f2_matmul_batched.launches = 0
f2_apply_scatter.launches = 0


def matrix_rows(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The nonzero lists of the columns of an (n, m) uint8 GF(256) matrix M,
    for :func:`gf_matvec_wide`: (idx (m, d) int32, coef (m, d) uint8), row
    i listing the j with M[j, i] != 0 in ascending order, padded with
    idx = n and coef 0 to the widest column d. Built once per matrix."""
    if mat.dtype != torch.uint8 or mat.dim() != 2:
        raise ValueError(f"matrix must be (n, m) uint8, got {tuple(mat.shape)} {mat.dtype}")
    n = mat.shape[0]
    nz = mat.t() != 0  # (m, n)
    d = max(1, int(nz.sum(dim=1).max())) if nz.numel() else 1
    order = torch.argsort((~nz).to(torch.uint8), dim=1, stable=True)[:, :d]  # nonzeros first
    keep = nz.gather(1, order)
    idx = torch.where(keep, order, n).to(torch.int32)
    coef = torch.where(keep, mat.t().gather(1, order), 0).to(torch.uint8)
    return idx.contiguous(), coef.contiguous()


# The dense route's block width (threads, one payload word each) in
# csrc/gfmm.cu: each thread keeps its 32 nibble products in shared memory
# at a row stride of TILE_THREADS words, which the offsets below encode.
TILE_THREADS = 64
TILE_FILL = 0.25  # least share of nonzero (row, column) pairs for the dense route


class GFTiles(NamedTuple):
    """An (n, m) GF(256) matrix cut into tiles of ``rows`` output rows, for
    the dense route of :func:`gf_matvec_wide` (``csrc/gfmm.cu``).

    cols: (T, C) int32, each tile's columns with a nonzero coefficient in
      one of its rows, ascending (pad 0). ncols: (T,) int32 their number.
    offs: (T, C, rows) int32, per (column, row) the coefficient c as the
      byte offsets of its two nibble products in a thread's table: low
      half (c & 15) * 4 * TILE_THREADS, high half (16 + (c >> 4)) * 4 *
      TILE_THREADS (rows 0 and 16 of the table hold zero, so c = 0 and pad
      rows add nothing). m: the output rows (tile t holds rows t * rows ..).
    """

    cols: torch.Tensor
    ncols: torch.Tensor
    offs: torch.Tensor
    rows: int
    m: int


def matrix_tiles(idx: torch.Tensor, coef: torch.Tensor, n: int) -> GFTiles | None:
    """The tiles of the matrix whose column lists are (idx, coef)
    (:func:`matrix_rows`; the Vlist for H), or None where the lists are
    sparse: fewer than :data:`TILE_FILL` of the tiles' (row, column) pairs
    nonzero, as for an LDPC Vlist, which the list route serves. Entries
    with idx outside [0, n) or coef 0 add nothing; repeated entries of one
    row add their coefficients. Built once per matrix (``CodeArrays.
    vlist_tiles`` caches the Vlist's)."""
    if idx.shape != coef.shape or idx.dim() != 2:
        raise ValueError(f"idx {tuple(idx.shape)} and coef {tuple(coef.shape)} must be (m, d)")
    m, d = idx.shape
    dev = idx.device
    ok = (idx >= 0) & (idx < n) & (coef != 0)
    dense = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    rows_ix = torch.arange(m, device=dev)
    for j in range(d):
        v = ok[:, j]
        dense[rows_ix[v], idx[v, j].long()] ^= coef[v, j]
    r = 16 if m <= 16 else 32 if m <= 32 else 64
    t = -(-m // r)
    cube = torch.zeros((t * r, n), dtype=torch.uint8, device=dev)
    cube[:m] = dense
    cube = cube.view(t, r, n)
    nz = (cube != 0).any(dim=1)  # (T, n)
    ncols = nz.sum(dim=1)
    if int((dense != 0).sum()) < TILE_FILL * r * max(1, int(ncols.sum())):
        return None
    c = max(1, int(ncols.max()))
    cols = torch.argsort((~nz).to(torch.uint8), dim=1, stable=True)[:, :c]
    keep = torch.arange(c, device=dev)[None, :] < ncols[:, None]
    cols = torch.where(keep, cols, 0)
    vals = cube.gather(2, cols[:, None, :].expand(t, r, c)).transpose(1, 2).int()  # (T, C, R)
    vals = torch.where(keep[:, :, None], vals, 0)
    stride = 4 * TILE_THREADS
    offs = (vals & 15) * stride | ((16 + (vals >> 4)) * stride) << 16
    return GFTiles(cols.to(torch.int32).contiguous(), ncols.to(torch.int32),
                   offs.to(torch.int32).contiguous(), r, m)


def gf_matvec_tiles_reference(values: torch.Tensor, tiles: GFTiles) -> torch.Tensor:
    """Plain PyTorch product over the tiles (the dense route's data): per
    tile and column, each row's coefficient read back from its offsets."""
    words = as_words(values, "values")
    b, _, w = words.shape
    stride = 4 * TILE_THREADS
    out = words.new_zeros(b, tiles.cols.shape[0] * tiles.rows, w)
    for t in range(tiles.cols.shape[0]):
        lo = (tiles.offs[t] & 0xFFFF) // stride
        hi = (tiles.offs[t] >> 16) // stride - 16
        coef = lo | hi << 4  # (C, R)
        acc = out[:, t * tiles.rows : (t + 1) * tiles.rows]
        for sp in range(int(tiles.ncols[t])):
            y = words[:, int(tiles.cols[t, sp])][:, None, :]  # (B, 1, W)
            acc ^= gf_mul_packed(y, coef[sp][None, :, None])
    return out[:, : tiles.m].contiguous().view(torch.uint8)


def _check_rows(values, idx, coef) -> torch.Tensor:
    words = as_words(values, "values")
    if words.dim() != 3:
        raise ValueError(f"values must be (B, n, W) bytes, got {tuple(values.shape)}")
    if idx.dtype != torch.int32 or coef.dtype != torch.uint8 or idx.dim() != 2:
        raise ValueError(f"idx must be (m, d) int32 and coef (m, d) uint8, got {idx.dtype}, "
                         f"{coef.dtype}")
    if idx.shape != coef.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and coef {tuple(coef.shape)} differ")
    if not (values.device == idx.device == coef.device):
        raise ValueError("values, idx and coef must be on one device")
    if not (idx.is_contiguous() and coef.is_contiguous()):
        raise ValueError("idx and coef must be contiguous")
    return words


def gf_matvec_wide_reference(
    values: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch product: a loop over the list slots, each a gather of
    one row per output row and a packed multiply by its coefficients."""
    words = _check_rows(values, idx, coef)
    b, n, w = words.shape
    vp = torch.cat([words, words.new_zeros(b, 1, w)], dim=1)  # index n reads zero
    ix = torch.where((idx >= 0) & (idx < n), idx, n).long()
    out = words.new_zeros(b, idx.shape[0], w)
    for s in range(idx.shape[1]):
        out ^= gf_mul_packed(vp[:, ix[:, s], :], coef[:, s, None])
    return out.view(torch.uint8)


def gf_matvec_wide(values: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, *,
                   tiles: GFTiles | None = None) -> torch.Tensor:
    """rhs[b, i, :] = sum_s coef[i, s] * values[b, idx[i, s], :] over
    GF(256): (B, n, W) uint8 -> (B, m, W) uint8, the "mw" layout.

    (idx, coef) are the nonzero lists of the columns of the (n, m) matrix M
    (:func:`matrix_rows`), so this is ``y . M`` of the TPU kernel; entries
    with idx outside [0, n) or coef 0 add nothing. With the Vlist
    (``vlist_idx``, ``vlist_val``) it is the syndrome H . y. CPU tensors
    take the plain version; CUDA tensors launch a kernel (or raise):

    * the dense route (the RS H) when :func:`matrix_tiles` tiles the lists:
      a thread per payload word holds a tile's output rows in registers;
      ``tiles`` passes the tiles of these lists, built once (else they are
      built here, on every call);
    * the list route (a sparse LDPC Vlist): a warp per output row walks its
      list.

    ``gf_matvec_wide.launches`` counts launches of either.
    """
    words = _check_rows(values, idx, coef)
    if words.device.type == "cpu":
        return gf_matvec_wide_reference(values, idx, coef)
    b, n, w = words.shape
    m, d = idx.shape
    if tiles is None:
        tiles = matrix_tiles(idx, coef, n)
    out = torch.empty((b, m, w), dtype=torch.int32, device=words.device)
    if tiles is not None:
        if tiles.m != m or tiles.cols.device != words.device:
            raise ValueError(f"tiles of {tiles.m} rows on {tiles.cols.device} for lists of {m} "
                             f"rows on {words.device}")
        t, c = tiles.cols.shape
        rc = _build.library().ldpc_gf_matvec_tiled_launch(
            words.data_ptr(), tiles.cols.data_ptr(), tiles.ncols.data_ptr(),
            tiles.offs.data_ptr(), out.data_ptr(), b, n, m, w, t, c, tiles.rows,
            _stream(words),
        )
        _build.check(rc, "ldpc_gf_matvec_tiled_launch")
    else:
        rc = _build.library().ldpc_gf_matvec_launch(
            words.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), b, n, m, d, w,
            _stream(words),
        )
        _build.check(rc, "ldpc_gf_matvec_launch")
    gf_matvec_wide.launches += 1
    return out.view(torch.uint8)


def _check_gf_apply(values, rhs, mats, idx) -> tuple[torch.Tensor, torch.Tensor]:
    words = as_words(values, "values")
    rw = as_words(rhs, "rhs")
    if words.dim() != 3 or rw.dim() != 3:
        raise ValueError(f"values and rhs must be (B, rows, W) bytes, got "
                         f"{tuple(values.shape)}, {tuple(rhs.shape)}")
    b, _, w = words.shape
    if rw.shape[0] != b or rw.shape[2] != w:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match values {tuple(values.shape)}")
    if mats.dtype != torch.uint8 or tuple(mats.shape[::2]) != (b, rw.shape[1]) or mats.dim() != 3:
        raise ValueError(f"mats must be (B, E, m) uint8 with m = {rw.shape[1]}, got "
                         f"{tuple(mats.shape)} {mats.dtype}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, mats.shape[1]):
        raise ValueError(f"idx must be ({b}, {mats.shape[1]}) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if not (values.device == rhs.device == mats.device == idx.device):
        raise ValueError("values, rhs, mats and idx must be on one device")
    if not (mats.is_contiguous() and idx.is_contiguous()):
        raise ValueError("mats and idx must be contiguous")
    return words, rw


def _gf_rows(rw: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """x = M_b . rhs_b over GF(256), (B, E, W) int32 words, by a loop over
    M's columns."""
    x = rw.new_zeros(rw.shape[0], mats.shape[1], rw.shape[2])
    for i in range(rw.shape[1]):
        x ^= gf_mul_packed(rw[:, i : i + 1, :], mats[:, :, i : i + 1])
    return x


def gf_apply_scatter_reference(
    values: torch.Tensor, rhs: torch.Tensor, mats: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch apply: x = T_b . rhs_b by a loop over T's columns, then
    the rows XORed into their targets."""
    words, rw = _check_gf_apply(values, rhs, mats, idx)
    b, n, w = words.shape
    x = _gf_rows(rw, mats)
    out = words.clone()
    keep = (idx >= 0) & (idx < n)
    frames = torch.arange(b, device=words.device)[:, None].expand_as(idx)
    f, t = frames[keep], idx[keep].long()
    out[f, t] ^= x[keep]
    return out.view(torch.uint8)


# The apply's tiles (csrc/gfmm.cu): R placed rows a block, R the first of
# GF_APPLY_ROWS that holds E rows (more tiles past 32); the block stages
# its rows' table offsets for GF_APPLY_PANEL columns at a time.
GF_APPLY_ROWS = (16, 32)
GF_APPLY_PANEL = 32


def gf_apply_rows(e: int) -> int:
    """R, the placed rows per tile of the apply for E = ``e`` transform rows."""
    return next((r for r in GF_APPLY_ROWS if e <= r), GF_APPLY_ROWS[-1])


def gf_apply_smem(e: int, n: int, r: int) -> int:
    """Shared memory of an apply block (csrc/gfmm.cu): the nibble-product
    table (32 rows of TILE_THREADS words), the offsets of GF_APPLY_PANEL
    columns for R rows, the tile's rows and their count, E targets and a
    bit per symbol of the n."""
    return (4 * 32 * TILE_THREADS + 4 * GF_APPLY_PANEL * r + _r16(4 * r) + 16 + _r16(4 * e)
            + _r16(4 * -(-n // 32)))


def _nibble_products(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The nibble products of words x (B, W): (lo, hi) (B, 16, W), lo[c] =
    c * x for c < 16 and hi[c] = (c << 4) * x, from the 8 multiples x * x^t
    (7 doublings), as ``csrc/gf256.cuh::nibble_products`` tables them
    (for ``csrc/gfmm.cu``'s products and ``csrc/elim.cu``'s elimination)."""
    mult = [x]
    for _ in range(7):
        mult.append(_xtime_packed(mult[-1]))
    lo = x.new_zeros(x.shape[0], 16, x.shape[1])
    hi = torch.zeros_like(lo)
    for c in range(1, 16):
        t = (c & -c).bit_length() - 1  # the lowest set bit
        lo[:, c] = lo[:, c & (c - 1)] ^ mult[t]
        hi[:, c] = hi[:, c & (c - 1)] ^ mult[4 + t]
    return lo, hi


def gf_apply_tiles_reference(
    values: torch.Tensor, rhs: torch.Tensor, mats: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch apply in the kernel's order (``csrc/gfmm.cu``): each
    frame's placed rows (target in [0, n)) listed first, in row order, and
    cut into tiles of R = :func:`gf_apply_rows` (E) of them; the values
    copied; per tile and column i the nibble products of rhs row i, and
    each of the tile's rows adds lo[c & 15] ^ hi[c >> 4] for its
    coefficient c; each placed row's sum XORed into its target. Equal to
    :func:`gf_apply_scatter_reference`."""
    words, rw = _check_gf_apply(values, rhs, mats, idx)
    n = words.shape[1]
    e, m = mats.shape[1:]
    out = words.clone()
    keep = (idx >= 0) & (idx < n)
    r = gf_apply_rows(e)
    tile = (keep.cumsum(dim=1) - 1) // r  # the tile of each placed row
    for t in range(-(-e // r)):
        frames, rows = (keep & (tile == t)).nonzero(as_tuple=True)
        if not len(frames):
            continue
        acc = rw.new_zeros(len(frames), rw.shape[2])
        for i in range(m):
            lo, hi = _nibble_products(rw[:, i])
            c = mats[frames, rows, i].long()
            acc ^= lo[frames, c & 15] ^ hi[frames, c >> 4]
        out[frames, idx[frames, rows].long()] ^= acc
    return out.view(torch.uint8)


def launch_gf_apply(values: torch.Tensor, rhs: torch.Tensor, mats: torch.Tensor,
                    idx: torch.Tensor, r: int, *, copy: bool = True) -> torch.Tensor:
    """The apply's kernel on CUDA tensors with tiles of R = ``r`` placed rows
    (one of :data:`GF_APPLY_ROWS`, the block within shared memory). With
    ``copy=False`` the symbols that are not targets are left unwritten (the
    rows alone, for timing). Counts one launch of ``gf_apply_scatter``."""
    words, rw = _check_gf_apply(values, rhs, mats, idx)
    b, n, w = words.shape
    _, e, m = mats.shape
    if r not in GF_APPLY_ROWS or gf_apply_smem(e, n, r) > SMEM_LIMIT:
        raise ValueError(f"apply tiles of {r} rows: R must be one of {GF_APPLY_ROWS} with the "
                         f"block's shared memory within {SMEM_LIMIT} bytes (E={e}, n={n})")
    out = torch.empty_like(words)
    rc = _build.library().ldpc_gf_apply_launch(
        words.data_ptr(), rw.data_ptr(), mats.data_ptr(), idx.data_ptr(), out.data_ptr(), b, m,
        e, w, n, r, int(copy), _stream(words),
    )
    _build.check(rc, "ldpc_gf_apply_launch")
    gf_apply_scatter.launches += 1
    return out.view(torch.uint8)


def gf_apply_scatter(
    values: torch.Tensor, rhs: torch.Tensor, mats: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``values`` with row e of T_b . rhs_b over GF(256) XORed into symbol
    idx[b, e]: the solved rows placed in the erased slots (which hold zero).

    values (B, n, W) uint8, rhs (B, m, W) uint8, mats (B, E, m) uint8 (T),
    idx (B, E) int32; W % 4 == 0. Targets outside [0, n) are dropped (the
    TPU kernel's dump rows); targets in range must be distinct within a
    frame. Returns a new (B, n, W) uint8 tensor. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise) with tiles of
    :func:`gf_apply_rows` (E) placed rows: only the placed rows are
    computed, by the dense route's nibble products, and the copy of the
    values is the kernel's own. ``gf_apply_scatter.launches`` counts kernel
    launches.
    """
    _check_gf_apply(values, rhs, mats, idx)
    if values.device.type == "cpu":
        return gf_apply_scatter_reference(values, rhs, mats, idx)
    return launch_gf_apply(values, rhs, mats, idx, gf_apply_rows(mats.shape[1]))


def _check_gf_matmul(rhs, mats) -> torch.Tensor:
    rw = as_words(rhs, "rhs")
    if rw.dim() != 3:
        raise ValueError(f"rhs must be (B, m, W) bytes, got {tuple(rhs.shape)}")
    b, m, _ = rw.shape
    if mats.dtype != torch.uint8 or mats.dim() != 3 or tuple(mats.shape[::2]) != (b, m):
        raise ValueError(f"mats must be (B, E, m) uint8 with (B, m) = {(b, m)}, got "
                         f"{tuple(mats.shape)} {mats.dtype}")
    if rhs.device != mats.device:
        raise ValueError(f"rhs on {rhs.device}, mats on {mats.device}")
    if not mats.is_contiguous():
        raise ValueError("mats must be contiguous")
    return rw


def gf_matmul_batched_reference(rhs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch product: a loop over M's columns (as the apply's)."""
    return _gf_rows(_check_gf_matmul(rhs, mats), mats).view(torch.uint8)


def gf_matmul_tiles_reference(rhs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch product in the kernel's order (``csrc/gfmm.cu``, the
    apply's tiles with every row, in order): rows cut into tiles of R =
    :func:`gf_apply_rows` (E); per tile and column i the nibble products of
    rhs row i, and each of the tile's rows adds lo[c & 15] ^ hi[c >> 4] for
    its coefficient c; each sum written once, in row order. Equal to
    :func:`gf_matmul_batched_reference`."""
    rw = _check_gf_matmul(rhs, mats)
    e, m = mats.shape[1:]
    r = gf_apply_rows(e)
    out = rw.new_zeros(rw.shape[0], e, rw.shape[2])
    for e0 in range(0, e, r):
        acc = out[:, e0 : e0 + r]
        for i in range(m):
            lo, hi = _nibble_products(rw[:, i])
            c = mats[:, e0 : e0 + r, i, None].long().expand(-1, -1, rw.shape[2])
            acc ^= lo.gather(1, c & 15) ^ hi.gather(1, c >> 4)
    return out.view(torch.uint8)


def gf_matmul_batched(rhs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """x[b] = M_b . rhs[b] over GF(256): rhs (B, m, W) uint8 (W % 4 == 0),
    mats (B, E, m) uint8 -> (B, E, W) uint8, each frame with its own matrix.

    The TPU kernel takes (B, m_pad, W) and (B, e_pad, m_pad) operands padded
    to multiples of 8 with zeros; any m and E serve here, and padded
    operands give the padded product. ``gf_apply_scatter`` without the
    placement: the rows come back in order. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise): the apply's tiled
    product over every row, tiles of :func:`gf_apply_rows` (E) rows in
    order. ``gf_matmul_batched.launches`` counts kernel launches.
    """
    rw = _check_gf_matmul(rhs, mats)
    if rw.device.type == "cpu":
        return gf_matmul_batched_reference(rhs, mats)
    b, m, w = rw.shape
    e = mats.shape[1]
    out = torch.empty((b, e, w), dtype=torch.int32, device=rw.device)
    rc = _build.library().ldpc_gf_matmul_launch(
        rw.data_ptr(), mats.data_ptr(), out.data_ptr(), b, m, e, w, gf_apply_rows(e), _stream(rw)
    )
    _build.check(rc, "ldpc_gf_matmul_launch")
    gf_matmul_batched.launches += 1
    return out.view(torch.uint8)


gf_matvec_wide.launches = 0
gf_apply_scatter.launches = 0
gf_matmul_batched.launches = 0
