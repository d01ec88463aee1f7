"""Sustained RS streaming: chunked RS(255,192) decode over a stream several
times the card's memory.

Counterpart of ``scripts/bench_rs_stream.py``, run as::

    python -m ldpc_erasure_codes_tpu_torch.rs.stream [--quick] [--host-io]

with the JAX script's environment names and defaults: ``RS_BATCH`` frames a
chunk (2048; 256 with ``--quick``), ``RS_WB`` payload bytes a symbol
(1024), ``RS_E`` erasures a frame (32, drawn among the source symbols by
``np.random.default_rng(RS_E)`` as JAX draws them) and ``STREAM_X``, the
stream's size as a multiple of the card's memory (4; 0.05 with
``--quick``). JAX hard-codes a TPU v5e's 16 GiB; here the multiple is of
``utils.device.hbm_bytes()``, the card's ``total_memory``. ``--chunks N``
gives the count directly (the CPU has no card memory to size by) and
``--device cpu`` runs the plain versions.

Each chunk is ``c ⊗ cw0``: a GF(256) scalar multiple of the resident base
batch of codewords (again a codeword batch, by linearity), with its scalar
``c`` from a generator of its own, seeded with the chunk's index. It is
erased, decoded by ``rs_decode_wide`` (the three GF(256) GE kernels on the
card) and reduced to JAX's XOR digest (every decoded byte of the chunk
XORed, per byte position). Multiplying by ``c`` is GF(2)-linear, so the
digest must equal ``gf_mul(digest0, c)``, ``digest0`` being the base
codewords' digest: an exact check of every chunk, held on the device. The
digest cancels an error that repeats an even number of times at one byte
position (the same fault in every frame of an even batch), so each chunk
also holds ``CHECK_FRAMES`` of its decoded frames, byte for byte, to the
chunk it was given, the frames turning from chunk to chunk so that a
stream of B / ``CHECK_FRAMES`` chunks checks every frame whole. The
mismatches, the failed frames and the residual erasures are summed on the
device and read once at the end.

The driver reports the rate of a few chunks timed together (JAX's
"single-shot") and the sustained rate over the whole stream with one sync
at the end, in ms a chunk and information Gbps (B · k · 8 · WB bits a
chunk), their ratio, and the host syncs one chunk makes
(``torch.cuda.set_sync_debug_mode``), each with the line of this package
that makes it. ``--host-io`` adds a leg that stages two host chunks from
pinned memory with ``non_blocking`` copies on a side stream, double-buffered; they are real codewords (scalar multiples made on
the host with ``gf_mul_np``), so that leg checks its digests too.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_mul, table
from ldpc_erasure_codes_tpu_torch.gf.tables import gf_mul_np
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.rs.code import rs_code
from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode_wide, rs_encode
from ldpc_erasure_codes_tpu_torch.utils import profiling
from ldpc_erasure_codes_tpu_torch.utils.device import cuda_device, hbm_bytes
from ldpc_erasure_codes_tpu_torch.utils.profiling import (  # noqa: F401 (kept importable here)
    SYNC_WARNING,
    port_site,
    sync_sites,
)

N, K = 255, 192
# Decoded frames a chunk holds whole to its codewords, beside the digest.
CHECK_FRAMES = 4


def settings(quick: bool) -> dict:
    """Batch, payload bytes, erasures and stream multiple from the
    environment, with the JAX script's defaults."""
    return {
        "b": int(os.environ.get("RS_BATCH", "256" if quick else "2048")),
        "wb": int(os.environ.get("RS_WB", "1024")),
        "e": int(os.environ.get("RS_E", "32")),
        "stream_x": float(os.environ.get("STREAM_X", "0.05" if quick else "4")),
    }


def erasure_mask(b: int, e: int) -> np.ndarray:
    """(B, n) bool: ``e`` erasures a frame among the k source symbols, from
    ``np.random.default_rng(e)`` in the JAX script's order."""
    mask = np.zeros((b, N), dtype=bool)
    rng = np.random.default_rng(e)
    for i in range(b):
        mask[i, rng.choice(K, size=e, replace=False)] = True
    return mask


def xor_digest(v: torch.Tensor) -> torch.Tensor:
    """(B, n, W) uint8 -> (W,) uint8: the XOR of every frame's every symbol,
    per byte position (JAX's ``bitwise_xor.reduce`` over frames and
    symbols), by halving on the int32 words."""
    x = as_words(v, "decoded values").reshape(-1, v.shape[-1] // 4)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] ^ x[h:2 * h]
        if x.shape[0] % 2:
            y[0] ^= x[-1]
        x = y
    return x[0].view(torch.uint8)


def chunk_scalar(i: int, device: torch.device) -> torch.Tensor:
    """Chunk ``i``'s nonzero GF(256) scalar, a 0-d uint8 tensor on
    ``device`` drawn from a generator of its own seeded with ``i`` (no host
    sync)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(i)
    return torch.randint(1, 256, (), generator=gen, device=device, dtype=torch.uint8)


class RSStream:
    """The resident state of the stream on ``device``: the RS(255,192)
    tables, the base codewords ``cw0`` (B, n, WB) uint8 (source bytes from a
    generator seeded with ``seed``), the erasure mask, ``digest0``, and the
    device-side sums of digest mismatches, of mismatched bytes in the
    checked frames, and of failed frames plus residual erasures
    (:meth:`read`)."""

    def __init__(self, b: int, wb: int, e: int, device: torch.device, seed: int = 0):
        self.device = device
        self.b, self.wb, self.e = b, wb, e
        self.arrays = code_arrays(rs_code(N, K), device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        src = torch.randint(0, 256, (b, K, wb), generator=gen, device=device, dtype=torch.uint8)
        self.cw0 = rs_encode(self.arrays, src)
        self.mask = torch.from_numpy(erasure_mask(b, e)).to(device)
        self.digest0 = xor_digest(self.cw0)
        # cw0's bytes as int32 indices into a product-table row: a chunk is
        # one index_select (c ⊗ cw0 without a host sync or a wider copy).
        self._index = self.cw0.reshape(-1).to(torch.int32)
        self.mismatches = torch.zeros((), dtype=torch.int64, device=device)
        self.frame_mismatches = torch.zeros((), dtype=torch.int64, device=device)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self._check = torch.arange(CHECK_FRAMES, device=device)
        self._turn = 0  # the first frame the next chunk checks

    @property
    def chunk_bytes(self) -> int:
        return self.b * N * self.wb

    @property
    def info_bits(self) -> int:
        return self.b * K * 8 * self.wb

    def scaled(self, c: torch.Tensor) -> torch.Tensor:
        """``c ⊗ cw0`` for a 0-d uint8 scalar ``c`` on the device."""
        row = table("mul", self.device)[c.long()]
        return torch.index_select(row, 0, self._index).view(self.cw0.shape)

    def decode(self, cw: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """Erase, decode and check the chunk ``cw`` (= c ⊗ cw0): its digest
        against ``gf_mul(digest0, c)``, the next ``CHECK_FRAMES`` frames
        byte for byte against ``cw``, its failed frames and residual
        erasures, all summed on the device. Returns the decoded values."""
        recv = cw.masked_fill(self.mask[:, :, None], 0)
        v, e_out, failed = rs_decode_wide(self.arrays, recv, self.mask)
        self.mismatches += (xor_digest(v) != gf_mul(self.digest0, c)).sum()
        rows = (self._check + self._turn) % self.b
        self._turn = (self._turn + CHECK_FRAMES) % self.b
        self.frame_mismatches += (v[rows] != cw[rows]).sum()
        self.bad += failed.sum() + e_out.sum()
        return v

    def chunk(self, c: torch.Tensor) -> None:
        self.decode(self.scaled(c), c)

    def read(self) -> tuple[int, int, int]:
        """(digest mismatches, mismatched bytes in the checked frames, failed
        frames + residual erasures) so far."""
        return int(self.mismatches), int(self.frame_mismatches), int(self.bad)


# The names of :meth:`RSStream.read`'s counts in the driver's reports.
COUNTS = ("mismatches", "frame_mismatches", "bad")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def syncs_per_chunk(s: RSStream, i: int) -> tuple[int, list[str]]:
    """Host syncs chunk ``i`` makes (its scalar's draw included), as
    ``torch.cuda.set_sync_debug_mode`` warns of them, and the
    :func:`port_site` of each, in order."""
    _sync(s.device)
    with sync_sites() as sites:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s.chunk(chunk_scalar(i, s.device))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _sync(s.device)
    return len(sites), sites


def _host_chunk(cw0: np.ndarray, c: int) -> torch.Tensor:
    """c ⊗ cw0 on the host (``gf_mul_np`` a slice at a time), pinned."""
    out = np.empty_like(cw0)
    flat, dst = cw0.reshape(-1), out.reshape(-1)
    step = 1 << 24
    for lo in range(0, flat.size, step):
        dst[lo:lo + step] = gf_mul_np(flat[lo:lo + step], c)
    return torch.from_numpy(out).pin_memory()


def host_io_leg(s: RSStream, chunks: int, seed: int = 1) -> dict:
    """Decode ``chunks`` chunks staged from two pinned host chunks (scalar
    multiples of cw0 with scalars from ``np.random.default_rng(seed)``),
    copied ``non_blocking`` on a side stream into two device buffers in
    turn while the other decodes. Returns ms a chunk, Gbps_info, and the
    leg's own digest and frame mismatches and failed/residual count."""
    if s.device.type != "cuda":
        raise ValueError("the host-io leg stages pinned memory over a CUDA stream: it needs "
                         f"a card, not {s.device}")
    scal = [int(x) for x in np.random.default_rng(seed).integers(1, 256, 2)]
    cw0 = s.cw0.cpu().numpy()
    host = [_host_chunk(cw0, c) for c in scal]
    del cw0
    cs = [torch.tensor(c, dtype=torch.uint8, device=s.device) for c in scal]
    bufs = [torch.empty_like(s.cw0) for _ in range(2)]
    ready = [torch.cuda.Event() for _ in range(2)]
    free = [torch.cuda.Event() for _ in range(2)]
    main, side = torch.cuda.current_stream(s.device), torch.cuda.Stream(s.device)
    before = s.read()

    def stage(i: int) -> None:
        slot = i % 2
        with torch.cuda.stream(side):
            side.wait_event(free[slot])  # the slot's last decode is done
            bufs[slot].copy_(host[slot], non_blocking=True)
            ready[slot].record(side)

    _sync(s.device)
    t0 = time.perf_counter()
    stage(0)
    for i in range(chunks):
        slot = i % 2
        if i + 1 < chunks:
            stage(i + 1)
        main.wait_event(ready[slot])
        s.decode(bufs[slot], cs[slot])
        free[slot].record(main)
    _sync(s.device)
    dt = time.perf_counter() - t0
    after = s.read()
    return {"chunks": chunks, "ms": dt / chunks * 1e3,
            "gbps_info": chunks * s.info_bits / dt / 1e9,
            **dict(zip(COUNTS, (a - b for a, b in zip(after, before))))}


def run_stream(*, quick: bool = False, host_io: bool = False, device=None,
               chunks: int | None = None, trace_dir: str | None = None, log=print) -> dict:
    """The driver as a function: the JAX script's protocol on ``device``
    (the card unless given), at :func:`settings`, its numbers returned. The
    stream is ``max(2, ceil(STREAM_X × hbm_bytes() / chunk bytes))`` chunks
    (at least STREAM_X times the card's memory; JAX rounds down), or
    ``chunks``. ``trace_dir`` wraps one more chunk in
    :func:`utils.profiling.trace`. ``host_io`` raises on a CPU device."""
    device = cuda_device() if device is None else torch.device(device)
    cfg = settings(quick)
    b, wb, e, stream_x = cfg["b"], cfg["wb"], cfg["e"], cfg["stream_x"]
    if host_io and device.type != "cuda":
        raise ValueError("--host-io needs a CUDA device (pinned memory, a side stream)")
    s = RSStream(b, wb, e, device)
    mem = hbm_bytes(device) if device.type == "cuda" else None
    if chunks is None:
        if mem is None:
            raise ValueError("give chunks= on a device without card memory to size by")
        chunks = max(2, math.ceil(stream_x * mem / s.chunk_bytes))
    out = {"n": N, "k": K, "b": b, "wb": wb, "e": e, "chunks": chunks,
           "chunk_bytes": s.chunk_bytes, "stream_bytes": chunks * s.chunk_bytes,
           "hbm_bytes": mem, "device": str(device)}
    log(f"RS({N},{K}) stream: B={b}, {wb}-byte payloads, e={e}, {chunks} chunks = "
        f"{out['stream_bytes'] / 1e9:.1f} GB" + (
            f" ({out['stream_bytes'] / mem:.2f}x the card's memory)" if mem else ""))

    # Warm (kernel builds) + correctness: one chunk, read at once.
    s.chunk(chunk_scalar(999, device))
    warm = s.read()
    if warm != (0, 0, 0):
        raise RuntimeError(f"warm-up chunk: {dict(zip(COUNTS, warm))}")
    out["syncs_per_chunk"], out["sync_sites"] = (
        syncs_per_chunk(s, 998) if device.type == "cuda" else (None, None))

    reps = 3 if quick else 10
    scal = [chunk_scalar(10_000 + i, device) for i in range(reps)]
    _sync(device)
    t0 = time.perf_counter()
    for c in scal:
        s.chunk(c)
    _sync(device)
    dt1 = (time.perf_counter() - t0) / reps
    out["single_ms"], out["single_gbps"] = dt1 * 1e3, s.info_bits / dt1 / 1e9
    log(f"single-shot: {out['single_ms']:7.2f} ms/chunk  {out['single_gbps']:7.1f} Gbps info")

    # Sustained: every chunk enqueued, one sync at the end (the scalars are
    # drawn on the device, so nothing but the decode's own syncs waits).
    _sync(device)
    t0 = time.perf_counter()
    for i in range(chunks):
        s.chunk(chunk_scalar(i, device))
    _sync(device)
    dt = time.perf_counter() - t0
    out["sustained_ms"] = dt / chunks * 1e3
    out["sustained_gbps"] = chunks * s.info_bits / dt / 1e9
    out["sustained_over_single"] = out["sustained_gbps"] / out["single_gbps"]
    read = s.read()
    out.update(zip(COUNTS, read))
    log(f"sustained:   {out['sustained_ms']:7.2f} ms/chunk  {out['sustained_gbps']:7.1f} Gbps "
        f"info over {out['stream_bytes'] / 1e9:.1f} GB  (digest mismatches {out['mismatches']}, "
        f"frame mismatches {out['frame_mismatches']}, failed/resid {out['bad']}; "
        f"{100 * out['sustained_over_single']:.1f}% of single-shot; "
        f"{out['syncs_per_chunk']} host syncs a chunk"
        + (f" at {', '.join(out['sync_sites'])})" if out["sync_sites"] else ")"))
    if trace_dir is not None:
        with profiling.trace(trace_dir):
            s.chunk(chunk_scalar(chunks, device))
        if s.read() != read:
            raise RuntimeError(f"the traced chunk: {s.read()} after {read}")
    out["host_io"] = None
    if host_io:
        out["host_io"] = h = host_io_leg(s, max(2, chunks // 8))
        log(f"host-io:     {h['ms']:7.2f} ms/chunk  {h['gbps_info']:7.1f} Gbps info "
            f"({h['chunks']} chunks from pinned memory; digest mismatches {h['mismatches']}, "
            f"frame mismatches {h['frame_mismatches']}, failed/resid {h['bad']})")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ldpc_erasure_codes_tpu_torch.rs.stream")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--host-io", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--chunks", type=int, default=None,
                   help="chunk count instead of STREAM_X x the card's memory (needed on the CPU)")
    args = p.parse_args(argv)
    device = cuda_device() if args.device == "cuda" else torch.device(args.device)
    out = run_stream(quick=args.quick, host_io=args.host_io, device=device, chunks=args.chunks)
    print(json.dumps(out), flush=True)
    legs = [out] + ([out["host_io"]] if out["host_io"] else [])
    return 0 if all(leg[k] == 0 for leg in legs for k in COUNTS) else 1


if __name__ == "__main__":
    sys.exit(main())
