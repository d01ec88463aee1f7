"""Sequential (Gauss-Seidel) peeling decode of packed words.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_peel.py::
peel_decode_vmem`` (:1281-1786) with its production schedules "unrolled"
(+ fence gate) and "seq", which compute the same function. The TPU's
tile-major layout exists only for its VMEM; the port keeps the plain
(B, n, W) layout end to end. :func:`peel_decode` launches the CUDA kernel
``csrc/peel.cu`` for CUDA tensors and runs :func:`peel_decode_reference`
for CPU tensors.

GF(256) codes (``gf_order=256``) take uint8 byte symbols (W % 4 == 0),
viewed as int32 words of four bytes. A degree-1 check's weighted sum
``acc = sum_j coef_j * y_j`` leaves out the erased slot, which holds zero,
and the solved symbol is ``inv_s * acc`` (pallas_peel.py:295-300,
My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:37-48). The erasure mask and
the iteration counts evolve as in the binary decode: they do not depend on
the values or the coefficients.

Stopping is per frame: a frame stops after the first sweep that leaves its
first ``early_stop_k`` symbols known, or that changes nothing. The TPU
kernel stops per 32-frame tile, so with ``early_stop_k`` the two agree on
iteration counts, on the first-k mask and on every resolved value, and the
parity-region residual may differ (pallas_peel.py:1314-1320). The kernel
and :func:`peel_decode_reference` agree bit for bit on every output.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays


def _words(values: torch.Tensor, gf_order: int) -> torch.Tensor:
    """The int32 words the decode works on: ``values`` itself (binary) or
    the word view of its bytes (GF(256))."""
    if gf_order == 256:
        return as_words(values, "values")
    if gf_order != 2:
        raise ValueError(f"gf_order must be 2 or 256, got {gf_order}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be torch.int32 words, got {values.dtype}")
    return values


def _check(arrays: CodeArrays, values, erased, max_iters, early_stop_k) -> int:
    """Validate the inputs (``values`` as int32 words); returns k_stop."""
    if erased.dtype != torch.bool:
        raise TypeError(f"erased must be torch.bool, got {erased.dtype}")
    if values.dim() != 3 or values.shape[2] < 1:
        raise ValueError(f"values must be (B, n, W) with W >= 1, got {tuple(values.shape)}")
    b, n, _ = values.shape
    if erased.shape != (b, n):
        raise ValueError(f"erased shape {tuple(erased.shape)} != {(b, n)}")
    if n < arrays.min_n:
        raise ValueError(f"n={n} is shorter than the code's columns ({arrays.min_n})")
    if not (values.device == erased.device == arrays.device):
        raise ValueError(
            f"values on {values.device}, erased on {erased.device}, "
            f"code tables on {arrays.device}"
        )
    if not (values.is_contiguous() and erased.is_contiguous()):
        raise ValueError("values and erased must be contiguous")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} must be >= 0")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    if not 0 <= k_stop <= n:
        raise ValueError(f"early_stop_k={early_stop_k} outside 0..{n}")
    return k_stop


def peel_decode_reference(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode: a Python loop over sweeps and checks,
    vectorised over frames and words, with the kernel's per-frame stop."""
    words = _words(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    nbin = gf_order == 256
    b = words.shape[0]
    dev = words.device
    er = erased.clone()
    v = words.masked_fill(er[:, :, None], 0)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    lens = arrays.vlist_len.tolist()
    checks = [
        torch.tensor(row[:d], dtype=torch.long, device=dev)
        for row, d in zip(arrays.vlist_idx.tolist(), lens)
    ]
    coefs = [row[:d] for row, d in zip(arrays.vlist_val.tolist(), lens)]
    invs = [
        torch.tensor(row[:d], dtype=torch.int32, device=dev)
        for row, d in zip(arrays.vlist_inv_val.tolist(), lens)
    ]
    for it in range(max_iters):
        changed = torch.zeros(b, dtype=torch.bool, device=dev)
        for c, nb in enumerate(checks):
            e_nb = er[:, nb]  # (B, d)
            deg1 = (e_nb.sum(dim=1) == 1) & active
            if not bool(deg1.any()):
                continue
            f = deg1.nonzero().squeeze(1)
            rows = v[f[:, None], nb[None, :]]  # (F, d, W); the erased slot holds zero
            pos = e_nb[f].to(torch.int8).argmax(dim=1)  # (F,) the erased slot
            if nbin:
                acc = gf_mul_packed(rows[:, 0], coefs[c][0])
                for j in range(1, nb.numel()):
                    acc = acc ^ gf_mul_packed(rows[:, j], coefs[c][j])
                acc = gf_mul_packed(acc, invs[c][pos][:, None])
            else:
                acc = rows[:, 0]
                for j in range(1, nb.numel()):
                    acc = acc ^ rows[:, j]
            slot = nb[pos]
            v[f, slot] = acc
            er[f, slot] = False
            changed[f] = True
        fin = active & (er[:, :k_stop].sum(dim=1) == 0)
        iters[fin] = it + 1
        active = active & ~fin & changed
        if not bool(active.any()):
            break
    return (v.view(torch.uint8) if nbin else v), er, iters


def peel_decode(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peeling decode. Returns (values (B, n, W), erased (B, n) bool,
    iters (B,) int32), values in the input's type: int32 words for
    ``gf_order=2``, uint8 bytes (W % 4 == 0) for ``gf_order=256``.

    ``values`` may be the un-erased channel output: the masking is fused
    into the decode, and erased output slots hold zero. CPU tensors take
    :func:`peel_decode_reference`; CUDA tensors launch the kernel (or
    raise). ``peel_decode.launches`` counts binary kernel launches,
    ``peel_decode.launches_gf256`` GF(256) ones.
    """
    words = _words(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    if words.device.type == "cpu":
        return peel_decode_reference(
            arrays, values, erased, max_iters=max_iters, early_stop_k=early_stop_k,
            gf_order=gf_order,
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    nb = gf_order == 256
    b, n, w = words.shape
    out = torch.empty_like(words)
    er_out = torch.empty((b, n), dtype=torch.bool, device=words.device)
    iters = torch.empty((b,), dtype=torch.int32, device=words.device)
    rc = _build.library().ldpc_peel_launch(
        words.data_ptr(), erased.data_ptr(), arrays.vlist_idx.data_ptr(),
        arrays.vlist_len.data_ptr(), arrays.vlist_val.data_ptr(),
        arrays.vlist_inv_val.data_ptr(), out.data_ptr(), er_out.data_ptr(), iters.data_ptr(),
        b, n, arrays.m, arrays.dmax, w, k_stop, max_iters, int(nb),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    _build.check(rc, "ldpc_peel_launch")
    if nb:
        peel_decode.launches_gf256 += 1
    else:
        peel_decode.launches += 1
    return (out.view(torch.uint8) if nb else out), er_out, iters


peel_decode.launches = 0
peel_decode.launches_gf256 = 0
