"""Bit-exact checks of decodes, on the device that holds them.

``check_schedule`` holds the research peel schedules to their contracts
(tests/test_pallas_peel.py:71-98, :288-307, :702-723): "counted" and
"grouped" equal "seq" bit for bit, "jacobi" equals its plain version and,
on the first k, the Jacobi decoder. ``check_peel`` is the counterpart of
``ldpc_erasure_codes_tpu/utils/verify.py::_check_peel`` (:86-119),
``check_nb`` the contract of ``verify_nb`` (:154-220), ``check_hybrid``
that of ``verify_hybrid`` (:223-297) and ``check_rs`` that of ``verify_rs``
(:300-347).

For the peel, every resolved slot must hold the codeword, every slot still
erased must hold zero, and no slot may be erased that the channel did not
erase. For a sample of frames the mask and the iteration counts must equal
the plain PyTorch decode's: the mask evolves independently of the values,
so the sample decodes one word per symbol and stays cheap at any width.
The same sample goes through the NumPy oracle (``utils/oracle.py``, the
reference's sequential sweep on word 0's bit 0, or byte 0 for GF(256)),
the second judge, as JAX's ``_check_peel`` asks it (:97-108). All
comparisons run over the (B, n) codeword symbols only; the layout has no
pad column.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import from_vlist
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    peel_decode_jacobi,
    peel_decode_jacobi_reference,
)
from ldpc_erasure_codes_tpu_torch.utils import oracle


def _oracle_check(
    arrays: CodeArrays,
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    erased: torch.Tensor,
    iters: torch.Tensor,
    *,
    max_iters: int,
    early_stop_k: int | None,
    gf_order: int = 2,
) -> tuple[int, int]:
    """(mask mismatches, iteration mismatches) of a peel's frames against
    the oracle's decode of the same symbols (``oracle.peel_decode``, or
    ``peel_decode_nb`` for GF(256)), one frame at a time on the host.
    Without early stop the residual mask and the sweeps must equal the
    oracle's. With ``early_stop_k`` the oracle runs to its fixed point and
    the early-stop contract holds instead: every symbol the peel resolved
    is one the oracle resolves, and the peel took no more sweeps."""
    code = from_vlist("verify", arrays.n, arrays.n - arrays.m, arrays.vlist_idx.cpu().numpy(),
                      arrays.vlist_len.cpu().numpy(), arrays.vlist_val.cpu().numpy(),
                      gf_order=gf_order)
    peel = oracle.peel_decode_nb if gf_order == 256 else oracle.peel_decode
    sym = codewords[:, :, 0].cpu().numpy().astype(np.int64)
    if gf_order != 256:
        sym &= 1  # bit 0 of word 0
    mask, er, it = (x.cpu().numpy() for x in (channel_mask, erased, iters))
    mask_bad = iter_bad = 0
    for f in range(sym.shape[0]):
        out, o_iters = peel(code, np.where(mask[f], oracle.ERASED, sym[f]), max_iters=max_iters)
        o_er = out == oracle.ERASED
        if early_stop_k is None:
            mask_bad += int((o_er != er[f]).sum())
            iter_bad += int(o_iters != it[f])
        else:
            mask_bad += int((o_er & ~er[f]).sum())
            iter_bad += int(it[f] > o_iters)
    return mask_bad, iter_bad


def check_peel(
    arrays: CodeArrays,
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    values: torch.Tensor,
    erased: torch.Tensor,
    iters: torch.Tensor,
    *,
    max_iters: int,
    early_stop_k: int | None,
    n_ref: int = 8,
    gf_order: int = 2,
) -> dict:
    """Returns the mismatch counts and ``ok`` (all zero). Binary frames are
    int32 words, GF(256) frames uint8 bytes; the sample decodes one word
    (four bytes) per symbol, and its first ``n_ref`` frames also go through
    the oracle (:func:`_oracle_check`, its host seconds reported)."""
    resolved = ~erased[:, :, None]
    value_bad = int(((values != codewords) & resolved).sum())
    zero_bad = int(((values != 0) & ~resolved).sum())
    outside = int((erased & ~channel_mask).sum())
    nr = min(n_ref, codewords.shape[0])
    _, ref_er, ref_iters = peel_decode_reference(
        arrays,
        codewords[:nr, :, : (4 if gf_order == 256 else 1)].contiguous(),
        channel_mask[:nr].contiguous(),
        max_iters=max_iters,
        early_stop_k=early_stop_k,
        gf_order=gf_order,
    )
    mask_bad = int((ref_er != erased[:nr]).sum())
    iter_bad = int((ref_iters != iters[:nr]).sum())
    t0 = time.perf_counter()
    o_mask_bad, o_iter_bad = _oracle_check(
        arrays, codewords[:nr], channel_mask[:nr], erased[:nr], iters[:nr],
        max_iters=max_iters, early_stop_k=early_stop_k, gf_order=gf_order,
    )
    return {
        "ok": value_bad == zero_bad == outside == mask_bad == iter_bad == o_mask_bad
        == o_iter_bad == 0,
        "frames": int(codewords.shape[0]),
        "value_mismatches": value_bad,
        "erased_nonzero": zero_bad,
        "erased_outside_channel": outside,
        "ref_frames": nr,
        "ref_mask_mismatches": mask_bad,
        "ref_iter_mismatches": iter_bad,
        "oracle_mask_mismatches": o_mask_bad,
        "oracle_iter_mismatches": o_iter_bad,
        "oracle_seconds": time.perf_counter() - t0,
    }


def check_nb(
    arrays: CodeArrays,
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    values: torch.Tensor,
    erased: torch.Tensor,
    iters: torch.Tensor,
    *,
    max_iters: int,
    early_stop_k: int | None,
    n_ref: int = 8,
) -> dict:
    """:func:`check_peel` for a GF(256) peel of uint8 byte frames: resolved
    bytes exact, erased slots zero, and the sample's mask and iteration
    counts equal to the plain GF(256) decode's and held to the oracle's
    GF(256) peel (``verify_nb``)."""
    return check_peel(arrays, codewords, channel_mask, values, erased, iters,
                      max_iters=max_iters, early_stop_k=early_stop_k, n_ref=n_ref,
                      gf_order=256)


def check_rs(
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    values: torch.Tensor,
    erased: torch.Tensor,
    failed: torch.Tensor,
    *,
    n_minus_k: int,
) -> dict:
    """The RS decode's contract (``verify_rs``): a frame fails exactly when
    it lost more than n - k symbols (the MDS bound; RS has no other rank
    deficiency), every other frame equals its codeword byte for byte and
    keeps no erasure."""
    want_fail = channel_mask.sum(dim=1) > n_minus_k
    ok_f = ~failed
    flag_bad = int((failed != want_fail).sum())
    value_bad = int(((values != codewords) & ok_f[:, None, None]).sum())
    resid_bad = int((erased & ok_f[:, None]).sum())
    return {
        "ok": flag_bad == value_bad == resid_bad == 0,
        "frames": int(codewords.shape[0]),
        "failed_frames": int(failed.sum()),
        "failure_flag_mismatches": flag_bad,
        "value_mismatches": value_bad,
        "residual_on_solved": resid_bad,
    }


def _mismatch(got, want) -> int:
    """Largest |got - want| over a tuple of outputs (0 when equal)."""
    worst = 0
    for g, w in zip(got, want):
        diff = g != w
        if bool(diff.any()):
            worst = max(worst, int((g[diff].long() - w[diff].long()).abs().max()))
    return worst


def check_schedule(
    arrays: CodeArrays,
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    schedule: str,
    *,
    max_iters: int,
    early_stop_k: int | None,
    n_ref: int = 64,
    gf_order: int = 2,
    got=None,
) -> dict:
    """The contract of a peel kernel schedule on one batch. ``got`` is the
    kernel's (values, erased, iters) for these inputs (decoded here when
    None). "counted" and "grouped": equal to the "seq" kernel on the whole
    batch and to the plain sequential decode on the first ``n_ref`` frames.
    "jacobi": equal to its plain version on the first ``n_ref`` frames, at
    full width, and there to ``peel_decode_jacobi`` on the iteration counts,
    the first-k mask and every value both resolved. Always: resolved slots
    hold the codeword, erased slots zero. Returns the mismatch counts,
    ``max_abs_err`` (against the plain version) and ``ok``."""
    kw = dict(max_iters=max_iters, early_stop_k=early_stop_k, gf_order=gf_order)
    if got is None:
        got = peel_decode(arrays, codewords, channel_mask, schedule=schedule, **kw)
    values, erased, _ = got
    wide = ~erased[:, :, None]
    report = {
        "schedule": schedule,
        "frames": int(codewords.shape[0]),
        "value_mismatches": int(((values != codewords) & wide).sum()),
        "erased_nonzero": int(((values != 0) & ~wide).sum()),
    }
    nr = min(n_ref, codewords.shape[0])
    cw_r, mask_r = codewords[:nr].contiguous(), channel_mask[:nr].contiguous()
    sub = tuple(x[:nr] for x in got)
    if schedule == "jacobi":
        plain = peel_decode_jacobi_reference(arrays, cw_r, mask_r, **kw)
        jv, je, ji = peel_decode_jacobi(arrays, cw_r, mask_r, **kw)
        k = codewords.shape[1] if early_stop_k is None else early_stop_k
        both = ~je & ~sub[1]
        report["decoder_mismatches"] = int((ji != sub[2]).sum()) + int(
            (je[:, :k] != sub[1][:, :k]).sum()) + int((jv != sub[0])[both].sum())
    else:
        plain = peel_decode_reference(arrays, cw_r, mask_r, **kw)
        seq = peel_decode(arrays, codewords, channel_mask, schedule="seq", **kw)
        report["seq_mismatch"] = _mismatch(got, seq)
    report["ref_frames"] = nr
    report["max_abs_err"] = _mismatch(sub, plain)
    report["ok"] = all(v == 0 for f, v in report.items()
                       if f not in ("schedule", "frames", "ref_frames"))
    return report


def replay_residual(arrays: CodeArrays, channel_mask: torch.Tensor, sweeps: int) -> np.ndarray:
    """Host replay of the sequential peel's mask: (B,) bool, the frames
    still holding erasures after ``sweeps`` sweeps. The mask evolves
    independently of the values; all frames replay at once, check by check
    (a frame that has stopped changes no more, so no per-frame stop is
    needed)."""
    vi = arrays.vlist_idx.cpu().numpy()
    vl = arrays.vlist_len.cpu().numpy()
    mask = channel_mask.cpu().numpy()
    er = np.concatenate([mask, np.zeros((mask.shape[0], 1), bool)], axis=1)  # pad column n
    checks = [vi[c, : int(vl[c])] for c in range(vi.shape[0])]
    for _ in range(sweeps):
        for nbrs in checks:
            hit = er[:, nbrs].sum(axis=1) == 1
            if hit.any():
                er[np.ix_(hit, nbrs)] = False
    return er.any(axis=1)


def check_hybrid(
    arrays: CodeArrays,
    codewords: torch.Tensor,
    channel_mask: torch.Tensor,
    values: torch.Tensor,
    erased: torch.Tensor,
    failed: torch.Tensor,
    *,
    peel_iters: int,
    gf_order: int = 2,
    require_ge: bool = True,
) -> dict:
    """The hybrid decode's contract: every frame that did not fail equals
    its codeword bit for bit and keeps no residual; with ``require_ge`` the
    GE tier had work (``ge_frames``, the frames a ``peel_iters``-sweep peel
    leaves stuck, by :func:`replay_residual`, > 0; the mask evolves alike
    over both fields), which a point where the GE fires only on a stuck
    frame cannot promise; the failed count is reported. Frames are int32
    words for ``gf_order=2`` and uint8 bytes for ``gf_order=256``."""
    want = torch.uint8 if gf_order == 256 else torch.int32
    if values.dtype != want or codewords.dtype != want:
        raise TypeError(f"gf_order={gf_order} frames are {want}, got {values.dtype}, "
                        f"{codewords.dtype}")
    ok_f = ~failed
    value_bad = int(((values != codewords) & ok_f[:, None, None]).sum())
    resid_bad = int((erased & ok_f[:, None]).sum())
    ge_frames = int(replay_residual(arrays, channel_mask, peel_iters).sum())
    return {
        "ok": (value_bad == 0 and resid_bad == 0 and bool(ok_f.any())
               and (ge_frames > 0 or not require_ge)),
        "frames": int(codewords.shape[0]),
        "ge_frames": ge_frames,
        "failed_frames": int(failed.sum()),
        "value_mismatches": value_bad,
        "residual_on_solved": resid_bad,
    }
