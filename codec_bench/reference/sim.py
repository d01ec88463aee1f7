"""The FER simulation step's counters, worked out again from the seed.

The step of a pattern-only peel campaign (Table I of the MILCOM 2022 paper,
tex:195-210) is documented to draw batch j of call c of a run seeded s from
a ``torch.Generator`` on the run's device, seeded
``((s * 0x9E3779B1 + c) * 0x85EBCA77 + j) % 2**63``, and to lose symbol i of
a frame where ``torch.rand((B, n), generator=g) <= per``. This module keeps
its own copy of that draw, and from the masks alone works out what the JAX
and MATLAB decoders count:

* the peel: Jacobi flooding sweeps over the frozen Vlist and its column
  lists, each on the sweep's starting mask (a check with one erased
  neighbour resolves it).
  Sweeps run while some frame of the batch still misses one of its first k
  symbols and the last sweep resolved an erasure somewhere in the batch, at
  most ``max_iters``. A frame's count is the first sweep after which its
  first k are known: 1 where none of them was lost, ``max_iters`` where they
  never clear;
* per batch: a block error where a first-k symbol is left; RS(rs_n, rs_k)
  window failures where a window of rs_n symbols lost more than rs_n - rs_k
  (MDS, paper tex:220); the channel's erasures; the erasures left over all
  n (they depend on the batch-wide stop); the frames by count; no GE, so
  nothing failed by rank or bucket size.

A call sums its ``steps_per_call`` batches. The work runs batch by batch on
the run's device, whose generator the draw needs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from codec_bench.reference.codes import read_vlist

# Sweeps between the host's looks at whether a batch has stopped.
LOOK = 8
# The counters in the order the check reads them; the histogram last.
FIELDS = ("frames", "block_errors", "rs_block_errors", "rs_blocks", "ml_failed", "escalations",
          "erased_symbols", "residual_erasures", "iters_hist")


def batch_seed(seed: int, call: int, j: int) -> int:
    return ((seed * 0x9E3779B1 + call) * 0x85EBCA77 + j) % 2**63


def losses(seed: int, call: int, j: int, shape: tuple[int, int], per: float,
           device) -> torch.Tensor:
    """(B, n) bool, True where batch j of call ``call`` lost a symbol."""
    g = torch.Generator(device=device)
    g.manual_seed(batch_seed(seed, call, j))
    return torch.rand(shape, generator=g, device=device) <= per


def column_checks(idx: np.ndarray, n: int) -> np.ndarray:
    """(n, cmax) each symbol's checks, padded with m, from the padded Vlist
    (m, dmax)."""
    m = idx.shape[0]
    real = idx < n
    checks = np.repeat(np.arange(m), real.sum(axis=1))
    cols = idx[real]
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=n)
    slot = np.arange(cols.size) - np.repeat(np.cumsum(counts) - counts, counts)
    out = np.full((n, int(counts.max())), m, dtype=np.int64)
    out[cols[order], slot] = checks[order]
    return out


def peel(vlist: torch.Tensor, clist: torch.Tensor, mask: torch.Tensor, k: int,
         max_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the erasures left (B, n), each frame's count (B,) int64). A sweep
    resolves each erased symbol that lies in a check with one erased
    neighbour. The stop is decided on the card; the host looks every
    ``LOOK`` sweeps whether the batch has stopped."""
    b, n = mask.shape
    left = torch.cat([mask, mask.new_zeros(b, 1)], dim=1)  # column n: the Vlist's pad
    pad = left.new_zeros(b, 1)  # row m: the column lists' pad
    iters = torch.zeros((b,), dtype=torch.int64, device=mask.device)
    running = torch.ones((), dtype=torch.bool, device=mask.device)
    prev = None
    for it in range(max_iters):
        if it % LOOK == 0 and it and not bool(running):
            break
        cur = left.sum()
        running = running & left[:, :k].any()
        if prev is not None:
            running = running & (cur < prev)
        prev = cur
        single = (left[:, vlist].sum(dim=2, dtype=torch.int16) == 1) & running  # (B, m)
        left[:, :n] &= ~torch.cat([single, pad], dim=1)[:, clist].any(dim=2)
        iters = torch.where(~left[:, :k].any(dim=1) & (iters == 0) & running, it + 1, iters)
    iters = torch.where(iters == 0, max_iters, iters)
    return left[:, :n], torch.where(mask[:, :k].any(dim=1), iters, 1)


class Campaign:
    """The reference of one sim traffic on one code, on ``device``."""

    def __init__(self, traffic: dict, config: dict, root: str, device):
        code_file = os.path.join(root, config["code"]["file"])
        n, k, idx, _ = read_vlist(code_file)
        with np.load(code_file) as z:
            self.rs_n, self.rs_k = int(z["rs_n"]), int(z["rs_k"])
        self.n, self.k, self.device = n, k, device
        self.vlist = torch.from_numpy(idx).to(device)
        self.clist = torch.from_numpy(column_checks(idx, n)).to(device)
        self.batch, self.steps = traffic["batch"], traffic["steps_per_call"]
        self.per = traffic["loss"]["per"]
        self.max_iters = traffic["decoder"]["max_iters"]
        self.k_stop = k if traffic["decoder"]["early_stop_k"] else n

    def counters(self, seed: int, call: int) -> np.ndarray:
        """(len(FIELDS) - 1 + max_iters + 1,) int64: call ``call``'s counters."""
        b, n = self.batch, self.n
        total = torch.zeros((len(FIELDS) - 1 + self.max_iters + 1,), dtype=torch.int64,
                            device=self.device)
        for j in range(self.steps):
            mask = losses(seed, call, j, (b, n), self.per, self.device)
            left, iters = peel(self.vlist, self.clist, mask, self.k_stop, self.max_iters)
            rs_errors, rs_blocks = 0, 0
            if self.rs_n > 0 and n % self.rs_n == 0:
                lost = mask.reshape(b, n // self.rs_n, self.rs_n).sum(dim=2)
                rs_errors, rs_blocks = (lost > self.rs_n - self.rs_k).sum(), b * (n // self.rs_n)
            scalars = [b, left[:, : self.k].any(dim=1).sum(), rs_errors, rs_blocks, 0, 0,
                       mask.sum(), left.sum()]
            total[: len(scalars)] += torch.stack([torch.as_tensor(s, device=self.device)
                                                  for s in scalars]).to(torch.int64)
            total[len(scalars):] += torch.bincount(iters, minlength=self.max_iters + 1)
        return total.cpu().numpy()
