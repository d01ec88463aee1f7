"""Per-frame digests, so that every frame's output can be compared without
keeping it.

``digest = sum over known symbols p and words w of (x[p, w] * M[p, w] mod 2^32)``,
with fixed odd multipliers M. A changed bit changes its product mod 2^32
(M is odd), so it changes the sum; the window and the reference compute it by
the same function. ``known`` masks the symbols a frame delivers.
"""

from __future__ import annotations

import torch


def multipliers(n: int, words: int, device) -> torch.Tensor:
    """(n, W) odd int32 multipliers, the same in every run."""
    g = torch.Generator().manual_seed(0x5EED)
    m = torch.randint(-(2**31), 2**31, (n, words), dtype=torch.int32, generator=g) | 1
    return m.to(device)


def frames(x: torch.Tensor, mult: torch.Tensor, known: torch.Tensor | None = None) -> torch.Tensor:
    """(F,) int64 digests of (F, n', W) int32 frames, n' <= n; ``known``
    (F, n') bool keeps only those symbols."""
    prod = x * mult[: x.shape[1]]
    if known is not None:
        prod.masked_fill_(~known[:, :, None], 0)
    return prod.sum(dim=(1, 2), dtype=torch.int64)


def in_blocks(x: torch.Tensor, mult: torch.Tensor, known: torch.Tensor | None = None,
              block: int = 64) -> torch.Tensor:
    """:func:`frames` over ``block`` frames at a time, to bound the scratch."""
    return torch.cat([
        frames(x[s : s + block], mult, None if known is None else known[s : s + block])
        for s in range(0, x.shape[0], block)
    ])


def mask(m: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """(F,) int64 digests of (F, n) bool masks."""
    return (m.to(torch.int32) * mult[:, 0]).sum(dim=1, dtype=torch.int64)
