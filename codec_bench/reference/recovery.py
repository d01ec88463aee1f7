"""Which frames a decoder must recover, from the loss mask alone.

* ``peel_closure``: the peel's fixed point. Peeling resolves a symbol through
  any check that has it as its only erased neighbour; run to a fixed point,
  it leaves the largest stopping set inside the erasures, whatever the order
  of the checks. A peel that stops once the first k symbols are known, or
  after a sweep that resolves nothing, leaves exactly that set's first k.
* ``ml_rank``: maximum-likelihood decoding recovers a frame iff the erased
  columns of H are independent over the code's field: GF(2), or GF(256) for
  a lift. Over GF(256) the test runs on the peel's fixed point: a check with
  one erased neighbour makes that column independent of the others, so the
  erasures are independent iff what the peel leaves is.
* ``mds``: RS(n, k) recovers a frame iff it lost at most n - k symbols.
"""

from __future__ import annotations

import torch

from codec_bench.reference.codes import GF256, Code


def peel_closure(code: Code, mask: torch.Tensor) -> torch.Tensor:
    """(F, n) bool: the erasures left at the peel's fixed point."""
    f, n = mask.shape
    idx = torch.from_numpy(code.vlist).to(mask.device)  # (m, dmax), pad n
    left = torch.cat([mask, mask.new_zeros(f, 1)], dim=1)
    while True:
        nb = left[:, idx]  # (f, m, dmax)
        single = nb & (nb.sum(dim=2, keepdim=True) == 1)
        hits = torch.zeros((f, n + 1), dtype=torch.int32, device=mask.device)
        hits.scatter_add_(1, idx.reshape(1, -1).expand(f, -1), single.reshape(f, -1).to(torch.int32))
        hits[:, n] = 0
        if not bool(hits.any()):
            return left[:, :n]
        left &= hits == 0


def ml_rank(code: Code, mask: torch.Tensor) -> torch.Tensor:
    """(F,) bool: True where the erased columns of H are independent."""
    if code.h_nb is not None:
        return gf256_rank(code, peel_closure(code, mask))
    f, n = mask.shape
    m = code.m
    dev = mask.device
    nw = -(-m // 32)
    h = torch.from_numpy(code.h).to(dev, torch.int32)  # (m, n)
    h = torch.nn.functional.pad(h, (0, 0, 0, 32 * nw - m)).reshape(nw, 32, n)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    # (n, nw): column c's bits; distinct bits, so the int32 sum is their OR.
    cols = (h << shifts[None, :, None]).sum(dim=1, dtype=torch.int32).t().contiguous()
    count = mask.sum(dim=1)
    ok = count <= m
    rows = int(count[ok].max()) if bool(ok.any()) else 0
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :rows]
    real = torch.arange(rows, device=dev)[None, :] < count[:, None]
    vec = torch.where(real[:, :, None], cols[order], 0)  # (f, rows, nw)
    used = torch.zeros((f, rows), dtype=torch.bool, device=dev)
    rank = torch.zeros((f,), dtype=torch.int64, device=dev)
    ar = torch.arange(f, device=dev)
    for p in range(m if rows else 0):
        has = (((vec[:, :, p // 32] >> (p % 32)) & 1) == 1) & ~used
        found = has.any(dim=1)
        piv = has.to(torch.uint8).argmax(dim=1)
        prow = vec[ar, piv]  # (f, nw)
        has[ar, piv] = False
        vec ^= torch.where((has & found[:, None])[:, :, None], prow[:, None, :], 0)
        used[ar, piv] |= found
        rank += found
    return ok & (rank == count)


def gf256_rank(code: Code, mask: torch.Tensor) -> torch.Tensor:
    """(F,) bool: True where the erased columns of the GF(256) ``h_nb`` are
    independent over GF(256). Forward elimination, frames side by side: the
    erased columns in index order, the pivot of column c swapped into row c,
    and column c cleared from the rows below it. A frame is independent iff
    every one of its columns finds a pivot."""
    count = mask.sum(dim=1)
    ok = count <= code.m
    live = torch.nonzero(ok & (count > 0)).squeeze(1)
    if live.numel() == 0:
        return ok
    dev = mask.device
    mul, inv = (torch.from_numpy(t).to(dev) for t in GF256.frozen().tables())
    count = count[live]
    rows = int(count.max())
    order = torch.argsort((~mask[live]).to(torch.uint8), dim=1, stable=True)[:, :rows]
    real = torch.arange(rows, device=dev)[None, :] < count[:, None]
    h = torch.from_numpy(code.h_nb).to(dev)  # (m, n) uint8
    a = (h[:, order] * real).permute(1, 0, 2).contiguous()  # (f, m, rows)
    ar = torch.arange(live.numel(), device=dev)
    full = torch.ones_like(count, dtype=torch.bool)
    for c in range(rows):
        nz = a[:, c:, c] != 0
        full &= nz.any(dim=1) | (count <= c)  # past a frame's count: its padding
        piv = c + nz.to(torch.uint8).argmax(dim=1)
        prow = a[ar, piv, c:]
        a[ar, piv, c:] = a[ar, c, c:]
        prow = mul[(inv[prow[:, :1].long()].to(torch.int32) << 8) | prow]  # pivot 1; 0 where none
        fac = a[:, c + 1:, c].to(torch.int32) << 8
        a[:, c + 1:, c:] ^= mul[fac[:, :, None] | prow[:, None, :]]
    ok[live] = full
    return ok


def mds(code: Code, mask: torch.Tensor) -> torch.Tensor:
    """(F,) bool: True where at most n - k symbols were lost."""
    return mask.sum(dim=1) <= code.m


def recoverable(rule: str, code: Code, mask: torch.Tensor,
                k_region: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(recoverable (F,) bool, the fixed point's erasures (F, n) or None).
    For ``peel_closure`` a frame counts as recovered when its first
    ``k_region`` symbols are."""
    if rule == "peel_closure":
        left = peel_closure(code, mask)
        return ~left[:, :k_region].any(dim=1), left
    if rule == "ml_rank":
        return ml_rank(code, mask), None
    if rule == "mds":
        return mds(code, mask), None
    raise ValueError(f"unknown recovery rule {rule!r}")
