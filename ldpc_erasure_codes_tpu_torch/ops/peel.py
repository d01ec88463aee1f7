"""Peeling decode of packed words, in the schedules of the TPU kernel.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_peel.py::
peel_decode_vmem`` (:1281-1786) and its ``schedule`` argument
(:1456-1464). The TPU's tile-major layout exists only for its VMEM; the
port keeps the plain (B, n, W) layout end to end. For CUDA tensors
:func:`peel_decode` launches, per schedule:

* "seq" and "unrolled" (+ fence gate; the production schedules, one
  function): ``csrc/peel.cu``, the sequential (Gauss-Seidel) sweep;
* "counted" and "grouped": ``csrc/peel_sched.cu``, the same sequential
  function with live per-check counts, or with disjoint check groups whose
  loads are issued together;
* "jacobi": ``csrc/peel_sched.cu``, the Jacobi sweep with sweep-start
  detection (the XLA decoders' schedule, :mod:`.peel_jacobi`).

For CPU tensors it runs the plain versions: :func:`peel_decode_reference`
for the four sequential schedules, which compute one function bit for bit,
iteration counts included, and
:func:`.peel_jacobi.peel_decode_jacobi_reference` for "jacobi".

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
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi_reference

SCHEDULES = ("seq", "unrolled", "counted", "grouped", "jacobi")
_SCHED_CODE = {"counted": 0, "grouped": 1, "jacobi": 2}


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
    schedule: str = "seq",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peeling decode. Returns (values (B, n, W), erased (B, n) bool,
    iters (B,) int32), values in the input's type: int32 words for
    ``gf_order=2``, uint8 bytes (W % 4 == 0) for ``gf_order=256``.

    ``values`` may be the un-erased channel output: the masking is fused
    into the decode, and erased output slots hold zero. ``schedule`` is one
    of :data:`SCHEDULES` (the module docstring says which kernel runs
    each). CPU tensors take the plain versions; CUDA tensors launch the
    kernel (or raise). ``peel_decode.launches`` counts binary launches of
    ``csrc/peel.cu``, ``peel_decode.launches_gf256`` its GF(256) ones, and
    ``launches_<schedule>`` / ``launches_<schedule>_gf256`` those of
    ``csrc/peel_sched.cu``'s schedules.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    words = _words(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    kw = dict(max_iters=max_iters, early_stop_k=early_stop_k, gf_order=gf_order)
    if words.device.type == "cpu":
        if schedule == "jacobi":
            return peel_decode_jacobi_reference(arrays, values, erased, **kw)
        return peel_decode_reference(arrays, values, erased, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    nb = gf_order == 256
    b, n, w = words.shape
    out = torch.empty_like(words)
    er_out = torch.empty((b, n), dtype=torch.bool, device=words.device)
    iters = torch.empty((b,), dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    tables = (arrays.vlist_idx.data_ptr(), arrays.vlist_len.data_ptr(),
              arrays.vlist_val.data_ptr(), arrays.vlist_inv_val.data_ptr())
    outs = (out.data_ptr(), er_out.data_ptr(), iters.data_ptr())
    if schedule in ("seq", "unrolled"):
        rc = _build.library().ldpc_peel_launch(
            words.data_ptr(), erased.data_ptr(), *tables, *outs,
            b, n, arrays.m, arrays.dmax, w, k_stop, max_iters, int(nb), stream,
        )
        _build.check(rc, "ldpc_peel_launch")
        counter = "launches"
    else:
        if schedule == "counted" and arrays.dmax > 255:
            raise ValueError(f"schedule 'counted' keeps byte counts: dmax={arrays.dmax} > 255")
        rc = _build.library().ldpc_peel_sched_launch(
            _SCHED_CODE[schedule], words.data_ptr(), erased.data_ptr(), *tables,
            arrays.clist_idx.data_ptr(), arrays.clist_len.data_ptr(),
            arrays.check_groups.data_ptr(), *outs, b, n, arrays.m, arrays.dmax,
            arrays.clist_idx.shape[1], arrays.check_groups.shape[0], w, k_stop, max_iters,
            int(nb), stream,
        )
        _build.check(rc, "ldpc_peel_sched_launch")
        counter = f"launches_{schedule}"
    counter += "_gf256" if nb else ""
    setattr(peel_decode, counter, getattr(peel_decode, counter) + 1)
    return (out.view(torch.uint8) if nb else out), er_out, iters


peel_decode.launches = 0
peel_decode.launches_gf256 = 0
for _s in ("counted", "grouped", "jacobi"):
    setattr(peel_decode, f"launches_{_s}", 0)
    setattr(peel_decode, f"launches_{_s}_gf256", 0)
