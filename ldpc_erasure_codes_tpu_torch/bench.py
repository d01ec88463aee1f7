"""Headline benchmark of the port: LDPC erasure-decode information throughput.

The measurement of the root ``bench.py``, on an NVIDIA GPU: the (2040, 1530)
code at raw PER 14.06% with 8192-bit symbols (W = 256 words), B = 2048
frames, decoder throughput in information bits per second
(B * reps * k * 32W / T). Baseline: 36.3 Gbps on a Stratix 10 FPGA
(Latex/Milcom_2022_ErasureCodes.tex:185).

Timed region, as the root bench: each rep draws a fresh erasure mask on the
device and runs the peeling decode (masking fused into the kernel) with
first-k early stop, then consumes the decoded values by XOR-reducing a slice
of every frame. The source is drawn and encoded once, outside the loop.

Run: ``python -m ldpc_erasure_codes_tpu_torch.bench`` on a machine with a
CUDA card. Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}; the card, its power limit and the timing go to stderr.

:class:`HybridPath` is the hybrid decoder's counterpart of
``scripts/bench_hybrid_values.py::run_point`` (:30-89): the same encode
outside the timed region, and per rep a fresh mask, the hybrid decode
(peel, then the compacted GE) and the consumed values; ``chip_smoke.py``
times it at the GE-hot point ``HYBRID``.

:class:`ThroughputPath` is the CLI's ``throughput`` command
(:func:`make_throughput_step`) at one peel schedule: per rep a fresh mask,
the decode by that schedule's kernel (or the Jacobi decoder,
``impl="xla"``) with first-k early stop, and a one-pass digest of every
decoded word.

:class:`NBPath` is the GF(256) chain of ``scripts/bench_nb_stages.py``
(``enc_dec``, :111-124) and, with ``hybrid``, of
``scripts/bench_nb_pipeline.py`` (:37-57): ``n2040_k1530_gf256``, 1024-byte
symbols. :class:`RSPath` is ``scripts/bench_rs_wide.py`` (:34-101):
RS(255,192) wide decode of 1024-byte payloads under an i.i.d. mask or a
fixed erasure pattern. Both count information bits as
B * k * 8 * Wbytes per rep (bench_nb_stages.py:83) and keep the encode
outside the timed region.
"""

from __future__ import annotations

import json
import sys

import torch

from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures
from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode, get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu_torch.ops.peel import SCHEDULES, peel_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi
from ldpc_erasure_codes_tpu_torch.rs.code import rs_code
from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode_wide, rs_encode
from ldpc_erasure_codes_tpu_torch.utils.device import card_info, cuda_device

BASELINE_GBPS = 36.3
METRIC = "ldpc_decode_throughput_n2040_k1530_per0.1406"
B, W, PER, REPS, MAX_ITERS = 2048, 256, 0.1406, 10, 50
# The GE-hot hybrid point of scripts/bench_hybrid_values.py:104-109.
HYBRID = dict(b=1024, w=256, per=0.2031, peel_iters=10, emax=512, ge_subbatch=448)
# The GF(256) points: scripts/bench_nb_stages.py / bench_nb_pipeline.py
# (B=512, 1 KB symbols, PER .1406; the hybrid's production knobs) and
# scripts/bench_rs_wide.py (RS(255,192), B=1024, 1 KB payloads).
NB = dict(b=512, wb=1024, per=0.1406)
NB_HYBRID = dict(peel_iters=10, emax=128, ge_subbatch=64)
RS = dict(n=255, k=192, b=1024, wb=1024, per=0.15)


def random_words(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform random int32 words (all 32 bits) from ``generator``."""
    return torch.randint(
        -(2**31), 2**31, shape, dtype=torch.int32, generator=generator, device=device
    )


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of all elements of an int32 tensor, as a 0-d tensor."""
    x = x.reshape(-1)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return x.reshape(())


def make_throughput_step(
    code, arrays, *, batch: int, per: float, max_iters: int,
    impl: str = "pallas", schedule: str = "seq",
):
    """The ``throughput`` command's step ``step(generator, cw) -> (first-k
    residual, digest)``: an i.i.d. channel draw on the codewords' device,
    then the wide value decode with first-k early stop. ``impl="pallas"``
    is the peel kernel of ``schedule`` (``ops/peel.py`` SCHEDULES; the
    masking is fused into its copy-in); ``"xla"`` zeroes the erased slots
    and runs the Jacobi decoder ``peel_decode_jacobi`` (JAX's
    ``peel_decode_wide``).

    The outputs depend on the codeword values, so a measurement always
    includes the value decode (the JAX CLI's cli.py:104-109): the digest is
    the wrapping int32 sum of every decoded word at each word position,
    (W,) words, one reduction that reads the values once. The symbol width
    is the codewords'.
    """
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl must be 'pallas' or 'xla', got {impl!r}")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")

    def step(generator: torch.Generator, cw: torch.Tensor):
        mask = iid_erasures((batch, code.n), per, generator=generator, device=cw.device)
        kw = dict(max_iters=max_iters, early_stop_k=code.k)
        if impl == "pallas":
            values, erased, _ = peel_decode(arrays, cw, mask, schedule=schedule, **kw)
        else:
            values, erased, _ = peel_decode_jacobi(arrays, apply_erasures(cw, mask), mask, **kw)
        return erased[:, : code.k].sum(), values.sum(dim=(0, 1), dtype=torch.int32)

    return step


class MainPath:
    """The encode -> channel -> peel chain at one shape, on one device.

    Construction draws the source from ``seed`` and encodes it (outside any
    timed region); each :meth:`step` draws a fresh mask and decodes.
    """

    def __init__(self, code: LDPCCode, *, b: int, w: int, per: float, seed: int, device):
        self.code, self.b, self.w, self.per = code, b, w, per
        self.arrays: CodeArrays = code_arrays(code, device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        source = random_words((b, code.k, w), self.generator, device)
        self.codewords = encode_packed(self.arrays, source)

    def step(self):
        """One rep: returns (mask, values, erased, iters, consumed), where
        ``consumed`` holds the first-k residual, the largest iteration count
        and the XOR of the first two symbols of every frame."""
        code = self.code
        mask = iid_erasures(
            (self.b, code.n), self.per, generator=self.generator,
            device=self.codewords.device,
        )
        values, erased, iters = peel_decode(
            self.arrays, self.codewords, mask, max_iters=MAX_ITERS, early_stop_k=code.k
        )
        consumed = (erased[:, : code.k].sum(), iters.max(), xor_reduce(values[:, :2]))
        return mask, values, erased, iters, consumed

    def time_reps(self, reps: int) -> float:
        """Milliseconds per rep over ``reps`` reps, by CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = self.step()
        end.record()
        torch.cuda.synchronize()
        del out
        return start.elapsed_time(end) / reps

    def gbps(self, ms_per_rep: float) -> float:
        return self.b * self.code.k * 32 * self.w / (ms_per_rep * 1e-3) / 1e9


class HybridPath(MainPath):
    """The encode -> channel -> hybrid decode chain: the production branch
    (residual frames compacted into ``ge_subbatch``, the topology syndrome,
    the solved rows written back), ``peel_iters`` sweeps first."""

    def __init__(self, code: LDPCCode, *, b: int, w: int, per: float, seed: int, device,
                 peel_iters: int, emax: int, ge_subbatch: int):
        super().__init__(code, b=b, w=w, per=per, seed=seed, device=device)
        self.peel_iters, self.emax, self.ge_subbatch = peel_iters, emax, ge_subbatch
        self.failed_frames = 0
        self.frames = 0

    def step(self):
        """One rep: returns (mask, values, erased, iters, failed, consumed),
        where ``consumed`` holds the failed count, the frames left with a
        residual and the XOR of the first two symbols of every frame. Adds
        the failed count to ``failed_frames`` (one host sync per rep)."""
        mask = iid_erasures(
            (self.b, self.code.n), self.per, generator=self.generator,
            device=self.codewords.device,
        )
        values, erased, iters, failed = hybrid_decode(
            self.arrays, self.codewords, mask, peel_iters=self.peel_iters, emax=self.emax,
            ge_subbatch=self.ge_subbatch, tiled=True, static_topo=True, impl="vmem",
        )
        consumed = (failed.sum(), erased.any(dim=1).sum(), xor_reduce(values[:, :2]))
        self.failed_frames += int(consumed[0])
        self.frames += self.b
        return mask, values, erased, iters, failed, consumed

    def fer(self) -> float:
        """Frames failed over frames decoded since construction."""
        return self.failed_frames / max(self.frames, 1)


class ThroughputPath(MainPath):
    """The ``throughput`` command's step at one ``schedule`` (``impl``
    "pallas": the peel kernel of that schedule; "xla": the Jacobi
    decoder), on codewords encoded once at construction."""

    def __init__(self, code: LDPCCode, *, b: int, w: int, per: float, seed: int, device,
                 schedule: str = "seq", impl: str = "pallas"):
        super().__init__(code, b=b, w=w, per=per, seed=seed, device=device)
        self.schedule = schedule
        self.throughput_step = make_throughput_step(
            code, self.arrays, batch=b, per=per, max_iters=MAX_ITERS, impl=impl,
            schedule=schedule,
        )

    def step(self):
        """One rep: returns (first-k residual, digest (W,) words)."""
        return self.throughput_step(self.generator, self.codewords)


def random_bytes(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform random uint8 bytes from ``generator``, drawn as int32 words
    (the last dimension must be a multiple of 4)."""
    *lead, wb = shape
    return random_words((*lead, wb // 4), generator, device).view(torch.uint8)


class NBPath(MainPath):
    """The GF(256) encode -> channel -> decode chain on uint8 byte frames:
    the peel with first-k early stop and ``MAX_ITERS`` sweeps, or with
    ``hybrid`` (``NB_HYBRID``'s knobs) the hybrid decode, whose GE branch
    for GF(256) is the compacted byte Gauss-Jordan (``ge_solve``)."""

    def __init__(self, code: LDPCCode, *, b: int, wb: int, per: float, seed: int, device,
                 hybrid: dict | None = None):
        self.code, self.b, self.w, self.per, self.hybrid = code, b, wb, per, hybrid
        self.arrays = code_arrays(code, device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        source = random_bytes((b, code.k, wb), self.generator, device)
        self.codewords = encode_packed(self.arrays, source, gf_order=256)
        self.failed_frames = 0
        self.frames = 0

    def step(self):
        """One rep: returns (mask, values, erased, iters, failed, consumed);
        ``failed`` is None for the peel. ``consumed`` holds the first-k
        residual (peel) or the failed count (hybrid, added to
        ``failed_frames``: one host sync per rep), the largest iteration
        count and the XOR of the first two symbols of every frame."""
        code = self.code
        mask = iid_erasures((self.b, code.n), self.per, generator=self.generator,
                            device=self.codewords.device)
        failed = None
        if self.hybrid is None:
            values, erased, iters = peel_decode(
                self.arrays, self.codewords, mask, max_iters=MAX_ITERS, early_stop_k=code.k,
                gf_order=256)
            first = erased[:, : code.k].sum()
        else:
            values, erased, iters, failed = hybrid_decode(
                self.arrays, self.codewords, mask, gf_order=256, tiled=True, impl="vmem",
                **self.hybrid)
            first = failed.sum()
            self.failed_frames += int(first)
            self.frames += self.b
        consumed = (first, iters.max(), xor_reduce(values[:, :2].view(torch.int32)))
        return mask, values, erased, iters, failed, consumed

    def fer(self) -> float:
        return self.failed_frames / max(self.frames, 1)

    def gbps(self, ms_per_rep: float) -> float:
        return self.b * self.code.k * 8 * self.w / (ms_per_rep * 1e-3) / 1e9


class RSPath(NBPath):
    """RS(n, k) wide decode: payloads encoded once; each rep zeroes the
    erased slots and decodes with :func:`rs_decode_wide` (the three GF(256)
    GE kernels on every frame). ``pattern`` None draws an i.i.d. mask of
    erasure rate ``per`` per rep (``dec_iid``); a (B, n) bool tensor is
    used as it is on every rep (``dec``'s fixed patterns)."""

    def __init__(self, *, n: int, k: int, b: int, wb: int, per: float, seed: int, device):
        self.code, self.b, self.w, self.per = rs_code(n, k), b, wb, per
        self.arrays = code_arrays(self.code, device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        source = random_bytes((b, k, wb), self.generator, device)
        self.codewords = rs_encode(self.arrays, source)
        self.pattern: torch.Tensor | None = None
        self.failed_frames = 0
        self.frames = 0

    def systematic_pattern(self, e: int, seed: int) -> torch.Tensor:
        """(B, n) mask erasing ``e`` distinct systematic symbols per frame."""
        g = torch.Generator(device=self.codewords.device)
        g.manual_seed(seed)
        keys = torch.rand((self.b, self.code.k), generator=g, device=self.codewords.device)
        cols = keys.argsort(dim=1)[:, :e]
        mask = torch.zeros((self.b, self.code.n), dtype=torch.bool, device=keys.device)
        return mask.scatter_(1, cols, True)

    def step(self):
        """One rep: returns (mask, values, erased, failed, consumed), with
        ``consumed`` the failed count (added to ``failed_frames``: one host
        sync per rep) and the XOR of every frame's first two symbols."""
        mask = self.pattern
        if mask is None:
            mask = iid_erasures((self.b, self.code.n), self.per, generator=self.generator,
                                device=self.codewords.device)
        recv = self.codewords.masked_fill(mask[:, :, None], 0)
        values, erased, failed = rs_decode_wide(self.arrays, recv, mask)
        consumed = (failed.sum(), xor_reduce(values[:, :2].view(torch.int32)))
        self.failed_frames += int(consumed[0])
        self.frames += self.b
        return mask, values, erased, failed, consumed


def main() -> None:
    device = cuda_device()
    path = MainPath(get_code("n2040_k1530"), b=B, w=W, per=PER, seed=0, device=device)
    path.step()  # warm-up: builds the kernels on first use
    ms = path.time_reps(REPS)
    gbps = path.gbps(ms)
    print(
        f"card: {card_info()} | B={B} W={W} PER={PER} reps={REPS} "
        f"{ms:.3f} ms/rep info={gbps:.2f} Gbps",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(gbps, 3),
                "unit": "Gbps_info",
                "vs_baseline": round(gbps / BASELINE_GBPS, 3),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
