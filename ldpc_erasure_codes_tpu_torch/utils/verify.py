"""Bit-exact checks of binary decodes, on the device that holds them.

``check_peel`` is the counterpart of
``ldpc_erasure_codes_tpu/utils/verify.py::_check_peel`` (:86-119) and
``check_hybrid`` the contract of ``verify_hybrid`` (:223-297).

For the peel, every resolved slot must hold the codeword, every slot still
erased must hold zero, and no slot may be erased that the channel did not
erase. For a sample of frames the mask and the iteration counts must equal
the plain PyTorch decode's: the mask evolves independently of the values,
so the sample decodes one word per symbol and stays cheap at any width.
All comparisons run over the (B, n) codeword symbols only; the layout has
no pad column.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode_reference


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
) -> dict:
    """Returns the mismatch counts and ``ok`` (all zero)."""
    resolved = ~erased[:, :, None]
    value_bad = int(((values != codewords) & resolved).sum())
    zero_bad = int(((values != 0) & ~resolved).sum())
    outside = int((erased & ~channel_mask).sum())
    nr = min(n_ref, codewords.shape[0])
    _, ref_er, ref_iters = peel_decode_reference(
        arrays,
        codewords[:nr, :, :1].contiguous(),
        channel_mask[:nr].contiguous(),
        max_iters=max_iters,
        early_stop_k=early_stop_k,
    )
    mask_bad = int((ref_er != erased[:nr]).sum())
    iter_bad = int((ref_iters != iters[:nr]).sum())
    return {
        "ok": value_bad == zero_bad == outside == mask_bad == iter_bad == 0,
        "frames": int(codewords.shape[0]),
        "value_mismatches": value_bad,
        "erased_nonzero": zero_bad,
        "erased_outside_channel": outside,
        "ref_frames": nr,
        "ref_mask_mismatches": mask_bad,
        "ref_iter_mismatches": iter_bad,
    }


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
) -> dict:
    """The hybrid decode's contract: every frame that did not fail equals
    its codeword bit for bit and keeps no residual; the GE tier had work
    (``ge_frames``, the frames a ``peel_iters``-sweep peel leaves stuck, by
    :func:`replay_residual`, > 0); the failed count is reported."""
    ok_f = ~failed
    value_bad = int(((values != codewords) & ok_f[:, None, None]).sum())
    resid_bad = int((erased & ok_f[:, None]).sum())
    ge_frames = int(replay_residual(arrays, channel_mask, peel_iters).sum())
    return {
        "ok": value_bad == 0 and resid_bad == 0 and bool(ok_f.any()) and ge_frames > 0,
        "frames": int(codewords.shape[0]),
        "ge_frames": ge_frames,
        "failed_frames": int(failed.sum()),
        "value_mismatches": value_bad,
        "residual_on_solved": resid_bad,
    }
