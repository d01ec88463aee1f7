"""Bit-exact checks of a binary peel decode, on the device that holds it.

Counterpart of ``ldpc_erasure_codes_tpu/utils/verify.py::_check_peel``
(:86-119). Every resolved slot must hold the codeword, every slot still
erased must hold zero, and no slot may be erased that the channel did not
erase. For a sample of frames the mask and the iteration counts must equal
the plain PyTorch decode's: the mask evolves independently of the values,
so the sample decodes one word per symbol and stays cheap at any width.
All comparisons run over the (B, n) codeword symbols only; the layout has
no pad column.
"""

from __future__ import annotations

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
