"""Monte-Carlo statistics of the FER simulation.

Counterpart of ``ldpc_erasure_codes_tpu/sim/stats.py``: ``SimStats``
(:18-32), ``batch_stats`` (:35-94) and ``Accumulator`` (:97-140), the
FPGA's ERROR_STAT channel (OpenCL/device/ldpc_erasure_decoder_top.cl:46-55,
124-158) and the MATLAB sims' FER bookkeeping
(LDPCErasureCodes_MessagePassingAlgSim.m:214-236).

The per-batch fields are summable int64 tensors on the device; a call of
the simulation step sums them there, and :meth:`SimStats.to_host` reads
them all in one transfer. The host accumulates Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class SimStats(NamedTuple):
    """Per-batch counters (0-d int64 tensors, and the histogram)."""

    frames: torch.Tensor
    block_errors: torch.Tensor  # residual erasure among the first k (or all) symbols
    rs_block_errors: torch.Tensor  # failing RS windows (per window)
    rs_blocks: torch.Tensor  # RS windows scored (frames * n / rs_n)
    ml_failed: torch.Tensor  # singular or overflowed GE frames
    escalations: torch.Tensor  # frames failed by bucket size (residual > emax or
    #   past the ge_subbatch bucket: the frames hybrid_decode_escalated re-solves)
    erased_symbols: torch.Tensor  # channel erasures (the measured PER)
    residual_erasures: torch.Tensor  # erasures left after the decode
    iters_hist: torch.Tensor  # (max_iters + 1,) frames by iterations to finish

    def __add__(self, other: "SimStats") -> "SimStats":
        return SimStats(*(a + b for a, b in zip(self, other)))

    @classmethod
    def from_flat(cls, flat: torch.Tensor) -> "SimStats":
        """The counters of one int64 vector in the fields' order, the
        histogram's bins last: views of it."""
        nscalar = len(cls._fields) - 1
        return cls(*flat[:nscalar].unbind(), flat[nscalar:])

    def to_host(self) -> "SimStats":
        """The same counters as Python ints (the histogram a list), read
        from the device in one transfer."""
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in self]).tolist()
        nscalar = len(self) - 1
        return SimStats(*flat[:nscalar], flat[nscalar:])


def batch_stats(
    erased_in: torch.Tensor,
    erased_out: torch.Tensor,
    iters: torch.Tensor,
    failed: torch.Tensor | None,
    k: int,
    rs_n: int,
    rs_k: int,
    max_iters: int,
    count_all_symbols: bool = False,
    overflow: torch.Tensor | None = None,
) -> SimStats:
    """Fold one decoded batch into counters.

    Block error = any information symbol (first k; all n with
    ``count_all_symbols``) still erased, as the FPGA counts
    (decoder_perf_tests.cl:215-228). The RS comparison needs no RS decoder:
    by the MDS property a rate-matched RS(rs_n, rs_k) window fails iff it
    holds more than rs_n - rs_k channel erasures (paper tex:220), counted
    per window (MessagePassingAlgSim.m:199-205, :240). Iteration counts
    outside 0..max_iters land in the end bins. Nothing here reads the card:
    the histogram is counted into ``max_iters + 1`` zeros (``torch.bincount``
    reads the largest count on the host) and the constants are filled on the
    device (``torch.tensor`` copies from the host and waits for the stream).
    """
    b, n = erased_in.shape
    dev = erased_in.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    scope = erased_out if count_all_symbols else erased_out[:, :k]
    if rs_n > 0 and n % rs_n == 0:
        nwin = n // rs_n
        cnt = erased_in.reshape(b, nwin, rs_n).sum(dim=2)
        rs_errs = (cnt > rs_n - rs_k).sum()
        rs_blocks = torch.full((), b * nwin, dtype=torch.int64, device=dev)
    else:
        rs_errs = rs_blocks = zero
    bins = iters.clamp(0, max_iters).long()
    hist = torch.zeros((max_iters + 1,), dtype=torch.int64, device=dev)
    hist.index_add_(0, bins, torch.ones_like(bins))
    return SimStats(
        frames=torch.full((), b, dtype=torch.int64, device=dev),
        block_errors=scope.any(dim=1).sum(),
        rs_block_errors=rs_errs,
        rs_blocks=rs_blocks,
        ml_failed=failed.sum() if failed is not None else zero,
        escalations=overflow.sum() if overflow is not None else zero,
        erased_symbols=erased_in.sum(),
        residual_erasures=erased_out.sum(),
        iters_hist=hist,
    )


@dataclasses.dataclass
class Accumulator:
    """Host-side accumulation of :class:`SimStats` across calls (Python
    ints)."""

    frames: int = 0
    block_errors: int = 0
    rs_block_errors: int = 0
    rs_blocks: int = 0
    ml_failed: int = 0
    escalations: int = 0
    erased_symbols: int = 0
    residual_erasures: int = 0
    iters_hist: list[int] = dataclasses.field(default_factory=list)

    def add(self, s: SimStats) -> None:
        """Add one call's counters (device tensors: one host read)."""
        if isinstance(s.frames, torch.Tensor):
            s = s.to_host()
        for f in SimStats._fields[:-1]:
            setattr(self, f, getattr(self, f) + int(getattr(s, f)))
        h = [int(x) for x in s.iters_hist]
        if len(self.iters_hist) < len(h):
            self.iters_hist += [0] * (len(h) - len(self.iters_hist))
        for i, v in enumerate(h):
            self.iters_hist[i] += v

    @property
    def fer(self) -> float:
        return self.block_errors / max(self.frames, 1)

    @property
    def rs_fer(self) -> float:
        """Per-RS-window block error rate (the reference's normalisation)."""
        return self.rs_block_errors / max(self.rs_blocks, 1)

    @property
    def mean_iters(self) -> float:
        tot = sum(self.iters_hist)
        if not tot:
            return 0.0
        return sum(i * v for i, v in enumerate(self.iters_hist)) / tot
