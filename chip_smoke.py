#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it fails (exit code != 0, no result line) without them.

Phases, each fatal on failure:

1. the card: name and power limit, as ``nvidia-smi`` prints them;
2. build the CUDA kernels from ``ldpc_erasure_codes_tpu_torch/csrc``;
3. the encode and peel kernels against their plain PyTorch versions on
   the card, bit-exact: (2040,1530) at B=64 and (2000,1000) at B=16,
   W=256; the decode with and without first-k early stop; every shipped
   code (``SHIPPED``) in both fields at B=4: the encode takes its slab
   route and H ``f2_matvec_wide``'s list route (asserted);
3b. the hybrid decoder's GE kernels (elimination, topology syndrome, dense
   syndrome, transform rows, transform apply) against their plain versions,
   bit-exact, on peeled frames: (2040,1530) B=64 PER .2031 emax 512,
   (2000,1000) B=16 PER .3906 emax 768 (a 224 KB cube in shared memory),
   and (4000,2000) B=4 emax 1024 (the cube in device memory); each H on
   ``f2_matvec_wide``'s list route and each apply at its preferred slab
   width (asserted);
4. the main path at full width through the entry points a user calls
   (``bench.MainPath``): (2040,1530), B=2048, W=256, PER 0.1406, first-k
   early stop, 50 sweeps at most. The launch counters are zeroed just
   before and read just after; the first decode is verified bit-exactly
   (``utils/verify.py::check_peel``, which also holds 8 frames' masks and
   sweeps to the NumPy oracle ``utils/oracle.py``, its seconds logged),
   then 10 reps are timed with CUDA events;
4b. the hybrid path at full width (``bench.HybridPath``, the GE-hot point
   of scripts/bench_hybrid_values.py): (2040,1530), B=1024, W=256, PER
   .2031, 10 peel sweeps, emax 512, a GE bucket of 448 frames, the rows
   written back with the topology syndrome (on ``f2_matvec_wide``'s list
   route, counted as ``syndrome_from_topo``: no dense syndrome is counted).
   Counters zeroed before, read after; the first decode verified
   (``check_hybrid``), then 5 reps timed;
4c. ``hybrid_decode_escalated`` through ``compact_ge_solve`` with buckets
   too small for the batch (emax 128, 64 frames), so escalation fires;
   verified, and held against the production branch on the same mask;
   the escalated decode timed;
5. each kernel's time against its plain version's at the main path's
   shapes (phase 4 for encode and peel, phase 4b's GE bucket for the rest),
   with the outputs compared again, and the hybrid step's stages; the seq
   peel's schedule kernel against its plain version, timed alone, and the
   whole peel at each slab width Wc; the encode (slab route) and
   ``f2_matvec_wide`` (H's list route, on the GE bucket) at each slab
   width Wc, beside the slab load alone (the kernel with its compute cut),
   a copy of the same frames and the route each replaced (the per-warp
   encode, the bit scan); ``f2_eliminate`` on the GE bucket with the panels
   it runs (from the panel order's plain version) against the column
   order's steps, both memory modes and both cut settings held to the plain
   versions, the device-memory mode timed; ``f2_apply_scatter`` at each
   slab width Wc, its placed rows, the fused copy alone (no row placed)
   beside a ``clone`` of the values; ``f2_matmul_batched`` by route (the
   list route asserted at the bucket) and at each slab width Wc on the rows
   ``ge_solve_packed`` multiplies (those of slots it writes; the others cut
   to zero), beside the bit-scan route and the wrapper on every row uncut;
   ``syndrome_from_topo`` by route (the list route at each slab width Wc,
   asserted at the bucket, and the walk of ``csrc/synd.cu``), each held to
   the plain version, beside ``f2_matvec_wide`` on the same bucket;
6. GF(256): the GF(256) modes of encode and peel, the GF(256) elimination
   (both cube modes), ``gf_matvec_wide`` and ``gf_apply_scatter`` against
   their plain versions at small shapes, bit-exact;
6a. the NB main path (``bench.NBPath``): ``n2040_k1530_gf256``, B=512,
   1024-byte symbols, PER .1406, first-k early stop; counted, verified
   (``check_nb``, with the oracle's GF(256) peel on 8 frames), 5 reps
   timed;
6b. the NB hybrid, production knobs (10 sweeps, emax 128, bucket 64; its
   GE is the plain byte Gauss-Jordan ``ge_solve``); counted, verified
   (``check_hybrid``), 3 reps timed;
6c. NB escalation: B=64, PER .2031, emax 128, bucket 16, so the production
   branch overflows and ``ge_solve_wide_nb`` solves the rest with the cube
   in device memory; verified, the escalation call timed, with
   ``gf256_eliminate`` on its GE operands (held to the plain version, and
   its column steps alone, as in phase 6d) and ``gf_apply_scatter`` (as in
   phase 6d's split), and ``ge_solve``'s stage time;
6d. RS(255,192) wide decode (``bench.RSPath``), B=1024, 1024-byte
   payloads: verified on ``verify_rs``'s pattern (e = 1..63, one frame at
   64 that must fail, ``check_rs``), then the i.i.d. PER .15 and the e=63
   systematic legs timed; the three GF(256) GE kernels launch on every
   decode; ``gf256_eliminate`` on the i.i.d. batch's GE operands in both
   cube modes, and its column steps alone (the cubes' A block replaced by
   the identity: each column's pivot search, table build and pivot row,
   no other row updated);
7. each GF(256) kernel's time against its plain version's: encode and peel
   (with the schedule kernel, the Wc widths and the splits, as in phase 5)
   at phase 6a's shapes, the GE kernels at phase 6d's i.i.d. batch (``gf_matvec_wide``
   on its dense route: the RS H's tiles; 6c's LDPC Vlist takes the list
   route; ``gf_apply_scatter`` at each tile size R, its placed rows per
   frame, its fused copy alone beside a ``clone`` and its rows alone);
8. the ``throughput`` command by peel schedule (``bench.ThroughputPath``,
   ``bench.make_throughput_step``): (2040,1530), B=2048, W=256, PER
   .1406, first-k early stop, for each of "seq", "unrolled", "counted",
   "grouped" and "jacobi"; counted and timed per schedule, and the step's
   digest timed apart. On one fixed
   batch the three research kernels ("counted", "grouped" and "jacobi",
   visit orders of ``csrc/peel.cu``'s schedule kernel before its slab value
   kernel) are held against their plain versions on the whole batch,
   "counted" and "grouped" against the "seq" kernel, "jacobi" against the
   Jacobi decoder on the first k (``check_schedule``); each order's
   schedule kernel alone against its plain version (counted's and
   grouped's also against seq's schedule kernel) and timed beside seq's;
   their GF(256) modes against the plain versions at B=16, 1 KB. The CLI runs once as a subprocess;
9. the FER simulation at the paper's Table-I point (2040,1530), PER .1875:
   9a the CLI's pattern-only peel sweep (B=4096, 16 batches per call,
   VALIDATION.md:9-13), 9b the pattern-only hybrid of the JAX CLI's ``plot``
   (``run_fer_sweep``: 50 sweeps, emax 256, bucket B/8), both held to the
   bands of the published FER, RS FER and mean iterations; at emax 256 the
   hybrid's failures are frames whose residual outgrows the column bucket,
   as the JAX package's own pattern-only decoder flags them
   (``tests/test_torch_sim.py::test_hybrid_bucket_overflow_matches_jax``),
   so 9b runs again at emax 512, where no frame escalates; 9c value
   tracking at the FPGA shape (hybrid, W=256, B=2048, the flat handoff with
   the masking fused in the peel kernel), counted, its FER and escalations
   reported, and its stages timed one by one at its shape (channel,
   source, encode, peel, GE and within it the index and cube build, the
   elimination, the transform gather, the dense syndrome and the apply,
   the decode, one sim step; the elimination and the apply held to their
   plain versions on that batch). 9b's rank check is the rank kernel (``csrc/rank.cu``),
   counted; every count of 9a-9c must equal the recorded counts of the
   same seeds (``RECORDED_COUNTS``);
10. the last three kernels against their plain versions, bit-exact: the
   rank kernel on 9b's 512-frame bucket at emax 256 and 512 (each route:
   rows in registers, the matrix in shared memory, in device memory; the
   widest eliminated frame's column steps and the time per step), on
   (4000,2000) i.i.d. masks at emax 128 and 256 as the ML decoder checks
   them (shared and device memory, timed) and at emax 1024 (the matrix in
   device memory);
   ``channel_apply_per64`` at B=64 and at the main path's shape (beside the
   unfused ``iid_erasures_per64`` + ``apply_erasures``); ``gf_matmul_batched``
   on phase 6d's RS i.i.d. batch (counted, and held against its tiles twin
   ``gf_matmul_tiles_reference`` and the rows ``gf_apply_scatter`` places);
10b. the decoder-top leg, the FPGA's data_in analog (PARITY.md:60):
   (2040,1530), B=2048, W=256, encode -> ``channel_apply_per64`` at 9/64 ->
   seq peel with first-k stop; counted, verified (``check_peel``, the
   oracle's seconds logged), timed;
11. the parallel layer on the card: ``multihost.initialize`` over NCCL at
   world size 1 (``file://`` rendezvous), the sharded 9b and 9c steps equal
   to the unsharded ones, ``run_fer_point(mesh=...)`` at 9a's point equal to
   9a's counts, one ``cli scaling --devices 1`` subprocess,
   ``dryrun_multichip(1)``; the process group is destroyed before the end;
12. the PASSED/FAILED verification battery (``utils/verify.py::run_battery``)
   at full size in this process, counted: every tier PASSED and the hybrid
   tier holding GE-solved frames (``ge_frames > failed_frames``); then, as
   four subprocesses started together (120 s each at most), ``cli verify
   --quick`` and the ``golden`` commands of (2000,1000), its GF(256) lift
   (2040,1530) and RS(255,192), each PASSED; the native I/O library loaded.

``python3 chip_smoke.py --ge-kernels`` builds the kernels and only times
the topology syndrome, ``gf256_eliminate``, ``gf_matmul_batched`` and
``gf_apply_scatter`` on the operands of phases 5, 6c and 6d through the
public wrappers; copied to the root of an earlier checkout of the port, it
times that checkout's kernels on the same operands.

Every kernel's entry carries its bound: the larger of the bytes it must
move (inputs read once, outputs written once) over 3.35 TB/s and the
integer operations its inputs need over the card's INT32 rate (``bound``).
No single PyTorch call computes any of these GF(2)/GF(256) functions (the
unfused channel pair is two calls computing another stream), so
``library_ms`` is null throughout. The line before the last is a JSON
object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch import bench, sim
from ldpc_erasure_codes_tpu_torch.channel.erasure import (
    apply_erasures,
    iid_erasures,
    iid_erasures_per64,
)
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import _build, elim, nbmm, peel, rank, synd
from ldpc_erasure_codes_tpu_torch.ops import encode as enc
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.channel import (
    channel_apply_per64,
    channel_apply_per64_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.compact import residual_order
from ldpc_erasure_codes_tpu_torch.gf.ops import gf_inv, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops.elim import (
    f2_eliminate,
    f2_eliminate_reference,
    gf256_eliminate,
    gf256_eliminate_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.ge import (
    _unpack_words_bytes,
    coefficient_cube,
    coefficient_cube_nb,
    erased_indices,
    ge_rank_check_reference,
    ge_solve,
    ge_solve_packed,
    pivot_transforms,
)
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_scatter,
    f2_apply_scatter_reference,
    f2_matmul_batched,
    f2_matmul_batched_reference,
    f2_matvec_wide,
    f2_matvec_wide_reference,
    gf_apply_scatter,
    gf_apply_scatter_reference,
    gf_matmul_batched,
    gf_matmul_batched_reference,
    gf_matvec_wide,
    gf_matvec_wide_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import SCHEDULES, peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    peel_decode_jacobi_reference,
    peel_decode_mask,
)
from ldpc_erasure_codes_tpu_torch.ops.rank import erased_columns, f2_rank_check
from ldpc_erasure_codes_tpu_torch.parallel import default_mesh, multihost, shard_sim_step
from ldpc_erasure_codes_tpu_torch.parallel.dryrun import dryrun_multichip
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo, syndrome_from_topo_reference
from ldpc_erasure_codes_tpu_torch.rs import rs_code, rs_encode
from ldpc_erasure_codes_tpu_torch.utils import cli
from ldpc_erasure_codes_tpu_torch.utils import native
from ldpc_erasure_codes_tpu_torch.utils.device import card_info, cuda_device
from ldpc_erasure_codes_tpu_torch.utils.verify import (
    TIERS,
    check_hybrid,
    check_nb,
    check_peel,
    check_rs,
    check_schedule,
    run_battery,
)

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "encode_packed": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/encode.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_encode.py:223",
    ),
    "peel_decode": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:1281",
    ),
    "f2_eliminate": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/elim.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_elim.py:252",
    ),
    "syndrome_from_topo": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/f2mm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_synd.py:43",
    ),
    "f2_matvec_wide": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/f2mm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:342",
    ),
    "f2_matmul_batched": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/f2mm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:407",
    ),
    "f2_apply_scatter": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/f2mm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:465",
    ),
    "peel_decode_gf256": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:1281",
    ),
    "encode_packed_gf256": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/encode.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_encode.py:223",
    ),
    "gf256_eliminate": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/elim.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_elim.py:75",
    ),
    "gf_matvec_wide": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/gfmm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:132",
    ),
    "gf_apply_scatter": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/gfmm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:556",
    ),
    "peel_counted": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:586",
    ),
    "peel_grouped": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:1101",
    ),
    "peel_jacobi": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:377",
    ),
    "ge_rank": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/rank.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_ge.py:84",
    ),
    "channel_apply_per64": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/channel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_channel.py:54",
    ),
    "gf_matmul_batched": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/gfmm.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:241",
    ),
}
# Where each kernel's launches are counted: (wrapper, attribute). The
# encode and peel wrappers count their GF(256) mode apart.
COUNTERS = {
    "encode_packed": (encode_packed, "launches"),
    "peel_decode": (peel_decode, "launches"),
    "f2_eliminate": (f2_eliminate, "launches"),
    "syndrome_from_topo": (syndrome_from_topo, "launches"),
    "f2_matvec_wide": (f2_matvec_wide, "launches"),
    "f2_matmul_batched": (f2_matmul_batched, "launches"),
    "f2_apply_scatter": (f2_apply_scatter, "launches"),
    "peel_decode_gf256": (peel_decode, "launches_gf256"),
    "encode_packed_gf256": (encode_packed, "launches_gf256"),
    "gf256_eliminate": (gf256_eliminate, "launches"),
    "gf_matvec_wide": (gf_matvec_wide, "launches"),
    "gf_apply_scatter": (gf_apply_scatter, "launches"),
    "peel_counted": (peel_decode, "launches_counted"),
    "peel_grouped": (peel_decode, "launches_grouped"),
    "peel_jacobi": (peel_decode, "launches_jacobi"),
    "ge_rank": (f2_rank_check, "launches"),
    "channel_apply_per64": (channel_apply_per64, "launches"),
    "gf_matmul_batched": (gf_matmul_batched, "launches"),
}
# The research schedules' kernel entries; their GF(256) modes are held to
# the plain versions under the same entry.
SCHED_KERNELS = {"counted": "peel_counted", "grouped": "peel_grouped", "jacobi": "peel_jacobi"}
# The plain versions of csrc/peel.cu's schedule kernel, by visit order.
ORDER_PLAIN = {"grouped": peel.grouped_schedule_reference,
               "jacobi": peel.jacobi_schedule_reference,
               "counted": peel.counted_schedule_reference}
# Phase 9's bands at (2040,1530), PER .1875: VALIDATION.md:19 (peel FER
# 1.95e-2, +-3 sigma; the paper's 2e-2, tex:207), the analytic RS(255,192)
# per-window FER 7.34e-3, the Jacobi schedule's mean sweeps with first-k
# stop (VALIDATION.md:34) and the hybrid's FER (VALIDATION.md:59, 4.72e-3).
SIM_PER = 0.1875
PEEL_FER = (1.44e-2, 2.46e-2)
RS_FER = (6.3e-3, 8.4e-3)
PEEL_ITERS = (12.6, 13.6)
HYBRID_FER = (3.3e-3, 6.1e-3)
# Phase 9's counts as every earlier run of this script on the card recorded
# them (the same seeds; PERF.md): 9a 1263 block errors and 3880 RS window
# errors in 65536 frames; 9b 297 block errors in 65536 frames at emax 256,
# all 297 failed by bucket size, and none at emax 512; 9c 520 in 16384
# frames, each failed by bucket size. A rank check or a sharding that
# changed a flag or a random stream would change them.
RECORDED_COUNTS = {"9a": (65536, 1263, 3880), "9b": (65536, 297, 297, 297),
              "9b emax 512": (65536, 0, 0, 0), "9c": (16384, 520, 520, 520)}
# 9b's frames/s on the card with the plain pivot loop as its rank check
# (PERF.md), printed beside the rank kernel's.
PLAIN_LOOP_FPS = {"9b": 23281.8, "9b emax 512": 9045.7}
# Philox-4x32-10 per symbol: 10 rounds of two 32x32 products (hi and lo)
# and six XORs/adds.
PHILOX_OPS = 10 * 10

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): device memory
# 3.35 TB/s; INT32 16.7e12 operations/s (64 INT32 lanes per SM, half the
# 128 FP32 lanes behind the 67 TFLOP/s float32 rate, at 1.98 GHz on 132
# SMs). Every kernel here is integer XOR/shift work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# A GF(256) multiply-by-x of a packed word: shift, mask, shift, mask,
# multiply, XOR. A sum of products by known coefficients needs at least
# the 7 doublings of Horner's rule per output word plus one XOR per set
# coefficient bit (the TPU kernels' form); the bounds count that much.
XTIME_OPS = 6
HORNER_OPS = 7 * XTIME_OPS


# The shipped codes; each takes the encode's slab route and f2_matvec_wide's
# list route (asserted in phase 3).
SHIPPED = ("n2040_k1530", "n2000_k1000", "n4000_k2000", "n4080_k3060")

BINARY = ("encode_packed", "peel_decode", "f2_eliminate", "syndrome_from_topo",
          "f2_matvec_wide", "f2_matmul_batched", "f2_apply_scatter")


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the elements (0 when equal)."""
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = got != want
    if not bool(diff.any()):
        return 0
    return int((got[diff].long() - want[diff].long()).abs().max())


def outputs_err(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls (after a warm-up
    call), by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """(result, milliseconds) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def compare_small(device, errs: dict) -> None:
    """Phase 3: kernels against plain versions at small batch."""
    for name, b in (("n2040_k1530", 64), ("n2000_k1000", 16)):
        code = get_code(name)
        arrays = code_arrays(code, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        src = bench.random_words((b, code.k, bench.W), gen, device)
        cw = encode_packed(arrays, src)
        e = max_abs_err(cw, encode_packed_reference(arrays, src))
        errs["encode_packed"] = max(errs["encode_packed"], e)
        require(e == 0, f"{name}: encode kernel != plain (max abs err {e})")
        mask = iid_erasures((b, code.n), bench.PER, generator=gen, device=device)
        for esk in (None, code.k):
            kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=esk)
            got = peel_decode(arrays, cw, mask, **kw)
            want = peel_decode_reference(arrays, cw, mask, **kw)
            e = outputs_err(got, want)
            errs["peel_decode"] = max(errs["peel_decode"], e)
            require(e == 0, f"{name} early_stop_k={esk}: peel kernel != plain ({e})")
        torch.cuda.synchronize()
        log(f"phase 3: {name} B={b} W={bench.W}: encode and peel (early_stop_k None, k) "
            "bit-exact against the plain versions")
    for name in SHIPPED:
        for gf_order in (2, 256):
            code = get_code(name if gf_order == 2 else f"{name}_gf256")
            arrays = code_arrays(code, device)
            wc = enc.slab_words(arrays, bench.W, gf_order)
            require(wc is not None, f"{code.name}: the encode should take the slab route")
            src = (random_bytes((4, code.k, 4 * bench.W), 21, device) if gf_order == 256 else
                   bench.random_words((4, code.k, bench.W), torch.Generator(device=device),
                                      device))
            e = max_abs_err(encode_packed(arrays, src, gf_order=gf_order),
                            encode_packed_reference(arrays, src, gf_order=gf_order))
            key = "encode_packed_gf256" if gf_order == 256 else "encode_packed"
            errs[key] = max(errs[key], e)
            require(e == 0, f"{code.name}: encode slab kernel != plain ({e})")
            rows = nbmm.f2_slab_words(arrays.h_rows[0], code.n, bench.W)
            require(gf_order == 256 or rows is not None,
                    f"{name}: H should take f2_matvec_wide's list route")
            log(f"phase 3: {code.name} B=4 W={bench.W} words: the encode on its slab route "
                f"(Wc {wc}, {arrays.enc_levels.levels} levels) bit-exact against the plain "
                f"version" + (f"; H on f2_matvec_wide's list route (Wc {rows})"
                              if gf_order == 2 else ""))


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the INT32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": float(nbytes), "ops": float(ops)}


_POP = {}


def popcount(t: torch.Tensor) -> torch.Tensor:
    """Set bits of each byte of a uint8 tensor, as int64."""
    dev = str(t.device)
    if dev not in _POP:
        _POP[dev] = torch.tensor([bin(i).count("1") for i in range(256)], device=t.device)
    return _POP[dev][t.long()]


def word_popcount(t: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (last dimension summed)."""
    return popcount(t.contiguous().view(torch.uint8)).sum(dim=-1)


def elim_ops(cube: torch.Tensor, nreal: torch.Tensor, emax: int, a_words: int, gf: bool) -> int:
    """Integer operations the elimination of these cubes needs, counted by
    replaying it (the plain version's steps, with the same cuts): a GF(2)
    row update is one XOR per word; a GF(256) column costs the pivot row's
    Horner doublings and inverse product, then one XOR per set factor bit
    per word of every updated row."""
    b, m, c = cube.shape
    dev = cube.device
    r = cube.clone()
    used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    frames = torch.arange(b, device=dev)
    ub = min(int(nreal.max()), emax) if (a_words and b) else emax
    per, width, mask = (4, 8, 0xFF) if gf else (32, 1, 1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for col in range(ub):
        w = col // per
        colv = (r[:, :, w] >> (width * (col % per))) & mask
        cand = (colv != 0) & ~used
        has = cand.any(dim=1)
        piv = torch.where(has, cand.to(torch.uint8).argmax(dim=1), 0)
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        used |= is_piv
        c0 = min(w, a_words) if a_words else 0
        factor = torch.where(is_piv | ~has[:, None], 0, colv)
        nw = c - c0
        prow = r[frames, piv, c0:]
        if gf:
            inv = gf_inv(colv[frames, piv]).to(torch.int32)
            prow = gf_mul_packed(prow, inv[:, None])
            total += nw * ((popcount(inv.to(torch.uint8)) + HORNER_OPS) * has).sum()
            total += nw * popcount(factor.to(torch.uint8)).sum()
            upd = r[:, :, c0:] ^ gf_mul_packed(prow[:, None, :], factor[:, :, None])
            r[:, :, c0:] = torch.where(is_piv[:, :, None], prow[:, None, :], upd)
        else:
            total += nw * (factor != 0).sum()
            r[:, :, c0:] ^= torch.where(factor[:, :, None] != 0, prow[:, None, :], 0)
    return int(total)


class GEInputs:
    """The GE kernels' operands for peeled frames (values, erased), made as
    ``ge_solve_packed`` makes them; the elimination runs on the kernel."""

    def __init__(self, arrays, values, erased, emax: int):
        n = erased.shape[1]
        self.arrays, self.values = arrays, values
        self.emax = min(emax, n)
        self.er_idx, self.real, self.nreal = erased_indices(erased, self.emax)
        self.cube = coefficient_cube(arrays, self.er_idx, self.real)
        self.wa = -(-self.emax // 32)
        self.elim_out = f2_eliminate(self.cube, self.nreal, emax=self.emax, a_words=self.wa)
        self.t_rows = pivot_transforms(self.elim_out[0], self.elim_out[1], self.wa)
        self.idx = torch.where(self.real, self.er_idx, n).to(torch.int32)
        # The rows ge_solve_packed(return_rows=True) multiplies: those of
        # slots it writes, the others cut to zero.
        self.t_cut = torch.where((self.idx < n)[:, :, None], self.t_rows, 0)
        self.rhs = syndrome_from_topo(arrays, values)

    def bounds(self) -> dict:
        """name -> :func:`bound` of each GE kernel on these operands."""
        a, (b, n, w) = self.arrays, self.values.shape
        m, cw = self.cube.shape[1:]
        kw, e = self.t_rows.shape[2], self.emax
        edges = int(a.vlist_len.sum())
        terms = (word_popcount(self.t_rows) - 1).clamp(min=0)  # (B, E) XORs per word
        cut = (word_popcount(self.t_cut) - 1).clamp(min=0)
        placed = self.idx < n
        # The apply needs the rhs of frames with a placed row and the T rows
        # of placed rows only (the least work; the kernel reads no more).
        live = int(placed.any(dim=1).sum())
        return {
            "f2_eliminate": bound(
                8 * b * m * cw + 4 * b * e + 8 * b,
                elim_ops(self.cube, self.nreal, e, self.wa, gf=False)),
            "syndrome_from_topo": bound(4 * b * w * (n + m), b * w * (edges - m)),
            "f2_matvec_wide": bound(4 * b * w * (n + m) + a.h_words.numel() * 4,
                                    b * w * (edges - m)),
            "f2_matmul_batched": bound(4 * (b * m * w + b * e * kw + b * e * w),
                                       w * int(cut.sum())),
            "f2_apply_scatter": bound(
                4 * (2 * b * n * w + live * m * w + int(placed.sum()) * kw + b * e),
                w * int(terms[placed].sum())),
        }

    def kernels(self) -> dict:
        """name -> (kernel call, plain call) on these operands."""
        a, v, rhs, t = self.arrays, self.values, self.rhs, self.t_rows
        kw = dict(emax=self.emax, a_words=self.wa)
        return {
            "f2_eliminate": (lambda: f2_eliminate(self.cube, self.nreal, **kw),
                             lambda: f2_eliminate_reference(self.cube, self.nreal, **kw)),
            "syndrome_from_topo": (lambda: syndrome_from_topo(a, v),
                                   lambda: syndrome_from_topo_reference(a, v)),
            "f2_matvec_wide": (lambda: f2_matvec_wide(v, a.h_words, rows=a.h_rows),
                               lambda: f2_matvec_wide_reference(v, a.h_words)),
            "f2_matmul_batched": (lambda: f2_matmul_batched(rhs, self.t_cut),
                                  lambda: f2_matmul_batched_reference(rhs, self.t_cut)),
            "f2_apply_scatter": (lambda: f2_apply_scatter(v, rhs, t, self.idx),
                                 lambda: f2_apply_scatter_reference(v, rhs, t, self.idx)),
        }


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def peeled(code, arrays, b: int, per: float, sweeps: int, device):
    """Encoded random frames of ``code`` after a ``sweeps``-sweep peel of an
    i.i.d. mask: (values, erased)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    src = bench.random_words((b, code.k, bench.W), gen, device)
    cw = encode_packed(arrays, src)
    mask = iid_erasures((b, code.n), per, generator=gen, device=device)
    values, erased, _ = peel_decode(arrays, cw, mask, max_iters=sweeps)
    return values, erased


def compare_ge(device, errs: dict) -> None:
    """Phase 3b: the GE kernels against their plain versions. The smaller
    batches peel 3 sweeps, so that their frames keep residuals."""
    for name, b, per, sweeps, emax, in_smem in (
        ("n2040_k1530", 64, 0.2031, 10, 512, True),
        ("n2000_k1000", 16, 0.3906, 3, 768, True),
        ("n4000_k2000", 4, 0.40, 3, 1024, False),
    ):
        code = get_code(name)
        arrays = code_arrays(code, device)
        values, erased = peeled(code, arrays, b, per, sweeps, device)
        require(bool(erased.any()), f"{name}: the peel left no residual for the GE")
        ge = GEInputs(arrays, values, erased, emax)
        m, c = ge.cube.shape[1:]
        require(elim.fits_shared_memory(m, c) == in_smem,
                f"{name}: a ({m}, {c})-word cube should {'' if in_smem else 'not '}fit in "
                "shared memory")
        checks = ge.kernels()
        kw = dict(emax=ge.emax)
        checks["f2_eliminate a_words=0"] = (
            lambda: f2_eliminate(ge.cube, ge.nreal, **kw),
            lambda: f2_eliminate_reference(ge.cube, ge.nreal, **kw),
        )
        if in_smem:  # the device-memory mode on the same cube
            checks["f2_eliminate device memory"] = (
                lambda: elim.launch_kernel(ge.cube, ge.nreal, ge.emax, ge.wa, False),
                checks["f2_eliminate"][1],
            )
        for kname, (kern, plain) in checks.items():
            e = outputs_err(as_tuple(kern()), as_tuple(plain()))
            base = kname.split()[0]
            errs[base] = max(errs[base], e)
            require(e == 0, f"{name}: {kname} kernel != plain (max abs err {e})")
        require(nbmm.f2_slab_words(arrays.h_rows[0], code.n, bench.W) is not None,
                f"{name}: H should take f2_matvec_wide's list route")
        wc_apply = nbmm.f2_apply_slab_words(m, ge.emax, code.n, bench.W)
        require(wc_apply == nbmm.F2_APPLY_WORDS[0],
                f"{name}: the apply should take Wc {nbmm.F2_APPLY_WORDS[0]}, not {wc_apply}")
        e = max_abs_err(nbmm.f2_apply_rows_reference(values, ge.rhs, ge.t_rows, ge.idx),
                        f2_apply_scatter(values, ge.rhs, ge.t_rows, ge.idx))
        errs["f2_apply_scatter"] = max(errs["f2_apply_scatter"], e)
        require(e == 0, f"{name}: f2_apply_scatter != its plain list order ({e})")
        dense = f2_matvec_wide(values, arrays.h_words, rows=arrays.h_rows)
        require(torch.equal(dense, ge.rhs), f"{name}: dense and topology syndromes differ")
        failed = ge.elim_out[2]
        torch.cuda.synchronize()
        log(f"phase 3b: {name} B={b} W={bench.W} PER {per}, {sweeps} sweeps, emax {ge.emax}: "
            f"cube ({m}, {c}) "
            f"words in {'shared' if in_smem else 'device'} memory; "
            f"{int(erased.any(dim=1).sum())} residual frames, max residual "
            f"{int(ge.nreal.max())}, {int(failed.sum())} failed; GE kernels bit-exact "
            "against the plain versions; H on f2_matvec_wide's list route (Wc "
            f"{nbmm.f2_slab_words(arrays.h_rows[0], code.n, bench.W)}); the apply at Wc "
            f"{wc_apply}")


def hybrid_phase(device, card: str):
    """Phase 4b: the hybrid path at full width, counted, verified, timed."""
    code = get_code("n2040_k1530")
    h = bench.HYBRID
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    path = bench.HybridPath(code, seed=2024, device=device, **h)
    mask, values, erased, iters, failed, consumed = path.step()
    torch.cuda.synchronize()
    require(values.shape == (h["b"], code.n, h["w"]), f"values shape {tuple(values.shape)}")
    report = check_hybrid(path.arrays, path.codewords, mask, values, erased, failed,
                          peel_iters=h["peel_iters"])
    log(f"phase 4b: verify {json.dumps(report)}")
    require(report["ok"], "hybrid decode failed verification")
    del mask, values, erased, iters, failed, consumed
    ms = path.time_reps(5)
    counts = read_counts()
    for name in ("encode_packed", "peel_decode", "f2_eliminate", "syndrome_from_topo",
                 "f2_matmul_batched"):
        require(counts[name] > 0, f"the hybrid path never launched the {name} kernel")
    # The topology syndrome takes f2_matvec_wide's list route on its own
    # counter; nothing on this path runs the dense syndrome.
    require(synd.synd_route(code.n, code.m, path.arrays.dmax, h["w"]) == "list",
            "the hybrid's topology syndrome should take the list route")
    require(counts["f2_matvec_wide"] == 0,
            f"the hybrid path counted {counts['f2_matvec_wide']} dense syndromes")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 4b: hybrid {path.gbps(ms):.2f} Gbps info ({ms:.3f} ms/rep over 5 reps, "
        f"B={h['b']} W={h['w']} PER {h['per']} emax {h['emax']} ge_subbatch "
        f"{h['ge_subbatch']}); hybrid FER {path.fer():.4e} ({path.failed_frames}/"
        f"{path.frames}); GE frames in the verified rep {report['ge_frames']}; launches "
        f"{counts}; peak memory {peak_gb:.2f} GB; on {card}")
    return path, counts


def escalation_phase(path, device) -> dict:
    """Phase 4c: escalation through compact_ge_solve, counted and verified."""
    code, h = path.code, bench.HYBRID
    gen = torch.Generator(device=device)
    gen.manual_seed(77)
    mask = iid_erasures((h["b"], code.n), h["per"], generator=gen, device=device)
    zero_counts()
    v, e, it, f, n_esc = hybrid_decode_escalated(
        path.arrays, path.codewords, mask, peel_iters=h["peel_iters"], emax=128,
        ge_subbatch=64, impl="vmem",
    )
    torch.cuda.synchronize()
    counts = read_counts()
    report = check_hybrid(path.arrays, path.codewords, mask, v, e, f,
                          peel_iters=h["peel_iters"])
    log(f"phase 4c: escalated frames {n_esc}; verify {json.dumps(report)}; launches {counts}")
    require(report["ok"], "escalated hybrid decode failed verification")
    require(n_esc > 0, "escalation did not fire")
    for name in ("peel_decode", "f2_eliminate", "f2_matvec_wide", "f2_apply_scatter"):
        require(counts[name] > 0, f"the escalated path never launched the {name} kernel")
    v2, _, _, f2 = hybrid_decode(
        path.arrays, path.codewords, mask, peel_iters=h["peel_iters"], emax=h["emax"],
        ge_subbatch=h["ge_subbatch"], tiled=True, static_topo=True, impl="vmem",
    )
    both = ~f & ~f2
    require(not bool((f & ~f2).any()), "escalation failed a frame the production branch solved")
    require(torch.equal(v[both], v2[both]), "escalated and production values differ")
    ms = cuda_ms(lambda: hybrid_decode_escalated(
        path.arrays, path.codewords, mask, peel_iters=h["peel_iters"], emax=128,
        ge_subbatch=64, impl="vmem"), 3)
    log(f"phase 4c: failed frames escalated {int(f.sum())}, production branch {int(f2.sum())}; "
        f"values equal on frames both solved; the escalated decode {ms:.3f} ms (3 calls)")
    return counts


def ge_bucket(path, device):
    """Phase 4b's GE bucket on a fresh mask (seed 99): (mask, the peeled
    values and residual erasures, the indices of the first ge_subbatch
    residual frames)."""
    code, h = path.code, bench.HYBRID
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    mask = iid_erasures((h["b"], code.n), h["per"], generator=gen, device=device)
    values, erased, _ = peel_decode(path.arrays, path.codewords, mask, max_iters=h["peel_iters"])
    sel, _, _ = residual_order(erased, h["ge_subbatch"])
    return mask, values, erased, sel


def stage_times(path, device, errs: dict) -> tuple[dict, dict, dict]:
    """Phase 5 for the GE kernels at phase 4b's shapes (the bucket of the
    first ge_subbatch residual frames), and the hybrid step's stages."""
    code, h = path.code, bench.HYBRID
    mask, values, erased, sel = ge_bucket(path, device)
    stages = {}
    stages["peel"] = cuda_ms(
        lambda: peel_decode(path.arrays, path.codewords, mask, max_iters=h["peel_iters"]), 3)
    stages["residual gather"] = cuda_ms(lambda: (values[sel], erased[sel]), 5)
    vs, es = values[sel], erased[sel]
    ge = GEInputs(path.arrays, vs, es, h["emax"])

    def build():
        er_idx, real, _ = erased_indices(es, ge.emax)
        return coefficient_cube(path.arrays, er_idx, real)

    stages["cube build"] = cuda_ms(build, 5)
    times, plain = {}, {}
    for name, (kern, ref) in ge.kernels().items():
        times[name] = cuda_ms(kern, 5)
        want, plain[name] = host_ms(ref)
        e = outputs_err(as_tuple(kern()), as_tuple(want))
        errs[name] = max(errs[name], e)
        require(e == 0, f"phase-4b shape: {name} kernel != plain ({e})")
        del want
    stages["elimination"] = times["f2_eliminate"]
    mode = "shared" if elim.fits_shared_memory(*ge.cube.shape[1:]) else "device"
    log(f"phase 5: f2_eliminate on the GE bucket ({vs.shape[0]} frames, emax {ge.emax}, cube "
        f"{tuple(ge.cube.shape[1:])} words in {mode} memory): {times['f2_eliminate']:.3f} ms; "
        f"{elim_line(elim_split(ge.cube, ge.nreal, ge.emax, ge.wa, errs))}")
    split = apply_split(vs, ge.rhs, ge.t_rows, ge.idx, errs)
    log(f"phase 5: f2_apply_scatter on the GE bucket: {times['f2_apply_scatter']:.3f} ms; by Wc: "
        f"{apply_line(split)}")
    split = matmul_split(ge.rhs, ge.t_cut, ge.t_rows, errs)
    require(split["route"] == "list", f"the GE bucket's rows took the {split['route']} route")
    log(f"phase 5: f2_matmul_batched on the GE bucket: {times['f2_matmul_batched']:.3f} ms on the "
        f"{split['route']} route; by Wc: {matmul_line(split)}")
    stages["transform gather"] = cuda_ms(
        lambda: pivot_transforms(ge.elim_out[0], ge.elim_out[1], ge.wa), 5)
    stages["syndrome"] = times["syndrome_from_topo"]
    split = f2_matvec_split(path.arrays, vs, errs)
    log(f"phase 5: f2_matvec_wide (H, list route) on the GE bucket ({vs.shape[0]} frames, "
        f"W={h['w']}): {times['f2_matvec_wide']:.3f} ms; by Wc: {split_line(split)}")
    split = synd_split(path.arrays, vs, errs)
    require(split["route"] == "list", f"the GE bucket's syndrome took the {split['route']} route")
    log(f"phase 5: syndrome_from_topo (the Vlist as row lists) on the GE bucket "
        f"({vs.shape[0]} frames, W={h['w']}): {times['syndrome_from_topo']:.3f} ms on the "
        f"{split['route']} route (Wc {split['wc_default']}); by route: {synd_line(split)}; "
        f"beside f2_matvec_wide's list route on H {times['f2_matvec_wide']:.3f} ms")
    stages["apply (rows)"] = times["f2_matmul_batched"]
    x = f2_matmul_batched(ge.rhs, ge.t_cut)
    keep = ge.idx < code.n
    frames = sel[:, None].expand_as(ge.idx)[keep]
    target = ge.idx[keep].long()
    out = values.clone()
    stages["writeback"] = cuda_ms(lambda: out.index_put_((frames, target), x[keep]), 5)
    resid = int(erased.any(dim=1).sum())
    log(f"phase 5: GE bucket {vs.shape[0]} frames ({resid} residual in the batch), max residual "
        f"{int(ge.nreal.max())}, cube {tuple(ge.cube.shape)}")
    return times, plain, stages, ge.bounds()


def encode_bound(arrays, b: int, wbytes: int, gf: bool) -> dict:
    """Bound of the encode: source in, codewords out, the tables; per
    parity row an XOR per neighbour word (GF(2)) or, for GF(256), its
    Horner product sum and the product by the diagonal's inverse."""
    n, m = arrays.n, arrays.m
    words = wbytes // 4
    tabs = [arrays.enc_src_idx, arrays.enc_par_idx]
    if gf:
        tabs += [arrays.enc_src_val, arrays.enc_par_val, arrays.enc_diag_inv]
    nbytes = b * wbytes * ((n - m) + n) + sum(t.numel() * t.element_size() for t in tabs)
    if not gf:
        return bound(nbytes, b * words * (int(arrays.vlist_len.sum()) - 2 * m))
    pops = sum(int(popcount(t).sum()) for t in (
        arrays.enc_src_val, arrays.enc_par_val, arrays.enc_diag_inv))
    return bound(nbytes, b * words * (pops + 2 * m * HORNER_OPS))


def peel_bound(arrays, mask, erased_out, wbytes: int, gf: bool) -> dict:
    """Bound of the peel on this run's erasures: frames in and out, masks
    in and out; per resolved symbol its check's other neighbours summed
    (the mean check degree; GF(256): their Horner product sum and the
    product by the solved slot's inverse)."""
    b, n = mask.shape
    words = wbytes // 4
    resolved = int((mask & ~erased_out).sum())
    m, edges = arrays.m, int(arrays.vlist_len.sum())
    nbytes = b * n * (2 * wbytes + 2) + 4 * b
    if not gf:
        return bound(nbytes, resolved * (edges / m - 2) * words)
    support = arrays.vlist_idx < n
    row_pop = int(popcount(arrays.vlist_val).sum()) / m
    inv_pop = float(popcount(arrays.vlist_inv_val)[support].float().mean())
    return bound(nbytes, resolved * (row_pop + inv_pop + 2 * HORNER_OPS) * words)


def peel_split(arrays, cw, mask, k_stop: int, gf_order: int, errs: dict, name: str) -> dict:
    """The seq peel's two kernels at one shape: the schedule kernel held
    against its plain version and timed alone, and the whole decode timed
    at every slab width Wc (the wrapper's choice is ``peel.slab_words``)."""
    words = cw.view(torch.int32) if gf_order == 256 else cw
    got = peel.launch_schedule(arrays, mask, k_stop, bench.MAX_ITERS)
    want = peel.peel_schedule_reference(arrays, mask, max_iters=bench.MAX_ITERS,
                                        early_stop_k=k_stop)
    e = outputs_err(got, want)
    errs[name] = max(errs[name], e)
    require(e == 0, f"{name}: schedule kernel != plain ({e})")
    out = {"schedule_ms": cuda_ms(lambda: peel.launch_schedule(
        arrays, mask, k_stop, bench.MAX_ITERS), 5),
        "levels_max": int(got[2].max()), "resolutions_mean": float(got[1][:, -1].float().mean()),
        "wc_default": peel.slab_words(arrays, words.shape[1], words.shape[2], gf_order)}
    n = words.shape[1]
    # The value kernel's bytes alone (no sweep: the masked copy) and a plain
    # copy of the same frames, the yardstick for its device-memory rate.
    out["copy_ms"] = cuda_ms(lambda: peel.launch_kernel(arrays, words, mask, k_stop, 0,
                                                        gf_order), 5)
    out["clone_ms"] = cuda_ms(lambda: words.clone(), 5)
    out["wc"] = [wc for wc in peel.SLAB_WORDS
                 if peel.apply_smem(n, arrays.m, arrays.dmax, wc, gf_order) <= peel.SMEM_LIMIT]
    for wc in out["wc"]:
        out[f"wc{wc}_ms"] = cuda_ms(lambda: peel.launch_kernel(
            arrays, words, mask, k_stop, bench.MAX_ITERS, gf_order, wc), 5)
    return out


def order_split(arrays, mask, k_stop: int, schedule: str, errs: dict, name: str) -> dict:
    """A research schedule's kernel of ``csrc/peel.cu`` (its visit order of
    the schedule kernel) alone: held against its plain version on the whole
    batch ("grouped" and "counted" also against the seq order's kernel,
    whose schedule they must equal) and timed beside the seq order's."""
    got = peel.launch_schedule(arrays, mask, k_stop, bench.MAX_ITERS, schedule)
    want = ORDER_PLAIN[schedule](arrays, mask, max_iters=bench.MAX_ITERS, early_stop_k=k_stop)
    e = outputs_err(got, want)
    if schedule != "jacobi":
        e = max(e, outputs_err(got, peel.launch_schedule(arrays, mask, k_stop, bench.MAX_ITERS)))
    errs[name] = max(errs[name], e)
    require(e == 0, f"{name}: schedule kernel != plain ({e})")
    return {"schedule_ms": cuda_ms(lambda: peel.launch_schedule(
                arrays, mask, k_stop, bench.MAX_ITERS, schedule), 5),
            "seq_schedule_ms": cuda_ms(lambda: peel.launch_schedule(
                arrays, mask, k_stop, bench.MAX_ITERS), 5),
            "levels_max": int(got[2].max()),
            "resolutions_mean": float(got[1][:, -1].float().mean())}


def f2_matvec_split(arrays, values, errs: dict) -> dict:
    """``f2_matvec_wide``'s list route on H at one shape: the whole kernel
    at every slab width Wc that fits (the wrapper's choice is
    ``nbmm.f2_slab_words``), each held to the wrapper's output; the slab
    load alone (the same kernel with every row list cut to length 0, so
    it loads the slab and writes zeros); a ``clone`` of the values (n rows
    in and out, more bytes than the kernel's n in, m out); and the
    bit-scan route on the same inputs."""
    idx, length = arrays.h_rows
    _, n, w = values.shape
    m, d = idx.shape
    want = f2_matvec_wide(values, arrays.h_words, rows=arrays.h_rows)
    out = {"wc_default": nbmm.f2_slab_words(idx, n, w),
           "wc": [wc for wc in nbmm.F2_SLAB_WORDS
                  if nbmm.f2_rows_smem(n, m, d, wc) <= nbmm.SMEM_LIMIT]}
    for wc in out["wc"]:
        e = max_abs_err(nbmm.launch_rows(values, idx, length, wc), want)
        errs["f2_matvec_wide"] = max(errs["f2_matvec_wide"], e)
        require(e == 0, f"f2_matvec_wide list route at Wc {wc} != the default ({e})")
        out[f"wc{wc}_ms"] = cuda_ms(lambda: nbmm.launch_rows(values, idx, length, wc), 5)
    zero = torch.zeros_like(length)
    out["load_ms"] = cuda_ms(lambda: nbmm.launch_rows(values, idx, zero, out["wc_default"]), 5)
    out["clone_ms"] = cuda_ms(lambda: values.clone(), 5)
    e = max_abs_err(nbmm.launch_scan(values, arrays.h_words), want)
    errs["f2_matvec_wide"] = max(errs["f2_matvec_wide"], e)
    require(e == 0, f"f2_matvec_wide bit-scan route != list route ({e})")
    out["scan_ms"] = cuda_ms(lambda: nbmm.launch_scan(values, arrays.h_words), 3)
    return out


def synd_split(arrays, values, errs: dict) -> dict:
    """``syndrome_from_topo`` at one shape by route: the list route at every
    slab width Wc whose block fits (the wrapper's choice is
    ``nbmm.f2_slab_words`` of the Vlist) and the walk (``csrc/synd.cu``),
    each held to the plain version and timed."""
    _, n, w = values.shape
    m, d = arrays.vlist_idx.shape
    want = syndrome_from_topo_reference(arrays, values)
    out = {"route": synd.synd_route(n, m, d, w),
           "wc_default": nbmm.f2_slab_words(arrays.vlist_idx, n, w),
           "wc": [wc for wc in nbmm.F2_SLAB_WORDS
                  if nbmm.f2_rows_smem(n, m, d, wc) <= nbmm.SMEM_LIMIT]}
    calls = {f"list{wc}": (lambda wc=wc: synd.launch_list(arrays, values, wc))
             for wc in out["wc"]}
    calls["walk"] = lambda: synd.launch_walk(arrays, values)
    for name, call in calls.items():
        e = max_abs_err(call(), want)
        errs["syndrome_from_topo"] = max(errs["syndrome_from_topo"], e)
        require(e == 0, f"syndrome_from_topo ({name}) != plain ({e})")
        out[f"{name}_ms"] = cuda_ms(call, 5)
    return out


def synd_line(split: dict) -> str:
    """:func:`synd_split`'s times, for a log line."""
    return ", ".join([f"list Wc {wc} {split[f'list{wc}_ms']:.3f} ms" for wc in split["wc"]]
                     + [f"walk {split['walk_ms']:.3f} ms"])


def gf256_elim_split(ge, errs: dict) -> dict:
    """``gf256_eliminate`` on one set of GE operands (:class:`GEInputsNB`):
    the kernel (the wrapper's cube mode, and the device-memory mode where
    the cube fits shared memory) held to the plain version, which the
    table order's plain version must equal; and the column steps alone:
    the same cubes with their A block the identity, so that each column
    finds its pivot, builds its table and rewrites the pivot row, and no
    other row takes an update."""
    kw = dict(emax=ge.emax, a_words=ge.wa)
    want = gf256_eliminate_reference(ge.cube, ge.nreal, **kw)
    e = outputs_err(elim.gf256_eliminate_tables_reference(ge.cube, ge.nreal, **kw), want)
    require(e == 0, f"gf256_eliminate_tables_reference != gf256_eliminate_reference ({e})")
    b, m, c = ge.cube.shape
    in_smem = elim.fits_shared_memory_gf256(m, c)
    calls = {"wrapper": lambda: gf256_eliminate(ge.cube, ge.nreal, **kw)}
    if in_smem:
        calls["device"] = lambda: elim.launch_kernel_gf256(ge.cube, ge.nreal, ge.emax, ge.wa,
                                                           False)
    out = {"mode": "shared" if in_smem else "device", "frames": b, "m": m, "c": c}
    for name, call in calls.items():
        e = outputs_err(call(), want)
        errs["gf256_eliminate"] = max(errs["gf256_eliminate"], e)
        require(e == 0, f"gf256_eliminate ({name}) != plain ({e})")
        out[f"{name}_ms"] = cuda_ms(call, 5)
    k = min(m, ge.emax)
    eye = ge.cube.view(torch.uint8).view(b, m, 4 * c).clone()
    eye[:, :, : 4 * ge.wa] = 0
    eye[:, :k, :k] = torch.eye(k, dtype=torch.uint8, device=eye.device)
    eye = eye.view(torch.int32).view(b, m, c)
    e = outputs_err(gf256_eliminate(eye, ge.nreal, **kw),
                    gf256_eliminate_reference(eye, ge.nreal, **kw))
    errs["gf256_eliminate"] = max(errs["gf256_eliminate"], e)
    require(e == 0, f"gf256_eliminate (identity A) != plain ({e})")
    out["steps_ms"] = cuda_ms(lambda: gf256_eliminate(eye, ge.nreal, **kw), 5)
    return out


def gf256_elim_line(split: dict) -> str:
    """:func:`gf256_elim_split`'s times, for a log line."""
    parts = [f"{split['wrapper_ms']:.3f} ms on {split['frames']} cubes of ({split['m']}, "
             f"{split['c']}) words in {split['mode']} memory"]
    if "device_ms" in split:
        parts.append(f"the device-memory mode {split['device_ms']:.3f} ms")
    parts.append(f"the column steps alone (identity A: pivot search, table build, the pivot "
                 f"row) {split['steps_ms']:.3f} ms")
    return "; ".join(parts)


def elim_split(cube, nreal, emax: int, wa: int, errs: dict) -> dict:
    """``f2_eliminate`` on one set of cubes: the kernel held to the panel
    order's plain version (which counts the work: frames x panels, the
    panels not skipped as zero, their column steps) and, without the cuts,
    to the column order's; the device-memory mode held and timed on the
    same cubes."""
    kw = dict(emax=emax, a_words=wa)
    out = {}
    want = elim.f2_eliminate_panels_reference(cube, nreal, stats=out, **kw)
    checks = {
        "a_words wa": (lambda: f2_eliminate(cube, nreal, **kw), want),
        "a_words 0": (lambda: f2_eliminate(cube, nreal, emax=emax),
                      f2_eliminate_reference(cube, nreal, emax=emax)),
        "device memory": (lambda: elim.launch_kernel(cube, nreal, emax, wa, False), want),
    }
    for name, (kern, ref) in checks.items():
        e = outputs_err(kern(), ref)
        errs["f2_eliminate"] = max(errs["f2_eliminate"], e)
        require(e == 0, f"f2_eliminate ({name}) != plain ({e})")
    out["column_order_steps"] = cube.shape[0] * min(int(nreal.max()), emax)
    out["device_ms"] = cuda_ms(checks["device memory"][0], 5)
    return out


def elim_line(split: dict) -> str:
    """:func:`elim_split`'s counts and the device-memory time, for a log line."""
    return (f"panels {split['live_panels']} of {split['panels']} not skipped as zero, "
            f"{split['column_steps']} column steps in them against the column order's "
            f"{split['column_order_steps']}; the device-memory mode "
            f"{split['device_ms']:.3f} ms on the same cubes")


def apply_split(values, rhs, t_rows, idx, errs: dict) -> dict:
    """``f2_apply_scatter`` at one shape: the kernel at every slab width Wc
    that fits (the wrapper's choice is ``nbmm.f2_apply_slab_words``), each
    held to both plain versions; the placed rows; the fused copy alone
    (the same kernel with every target out of range, so no row is placed)
    and a ``clone`` of the same values."""
    _, n, w = values.shape
    k, e = rhs.shape[1], t_rows.shape[1]
    want = f2_apply_scatter_reference(values, rhs, t_rows, idx)
    e_rows = max_abs_err(nbmm.f2_apply_rows_reference(values, rhs, t_rows, idx), want)
    require(e_rows == 0, f"f2_apply_rows_reference != f2_apply_scatter_reference ({e_rows})")
    out = {"wc_default": nbmm.f2_apply_slab_words(k, e, n, w),
           "wc": [wc for wc in nbmm.F2_APPLY_WORDS
                  if nbmm.f2_apply_smem(k, e, n, wc) <= nbmm.SMEM_LIMIT],
           "placed": int(((idx >= 0) & (idx < n)).sum()), "rows": idx.numel()}
    for wc in out["wc"]:
        err = max_abs_err(nbmm.launch_apply(values, rhs, t_rows, idx, wc), want)
        errs["f2_apply_scatter"] = max(errs["f2_apply_scatter"], err)
        require(err == 0, f"f2_apply_scatter at Wc {wc} != plain ({err})")
        out[f"wc{wc}_ms"] = cuda_ms(lambda: nbmm.launch_apply(values, rhs, t_rows, idx, wc), 5)
    none = torch.full_like(idx, n)
    out["copy_ms"] = cuda_ms(
        lambda: nbmm.launch_apply(values, rhs, t_rows, none, out["wc_default"]), 5)
    out["clone_ms"] = cuda_ms(lambda: values.clone(), 5)
    return out


def apply_line(split: dict) -> str:
    """:func:`apply_split`'s times and counts, for a log line."""
    return (", ".join(f"{wc} words {split[f'wc{wc}_ms']:.3f} ms" for wc in split["wc"])
            + f" (default Wc {split['wc_default']}); placed rows {split['placed']} of "
            f"{split['rows']}; the fused copy alone (no row placed) {split['copy_ms']:.3f} ms, "
            f"a clone of the values {split['clone_ms']:.3f} ms")


def matmul_split(rhs, t_rows, t_all, errs: dict) -> dict:
    """``f2_matmul_batched`` at one shape: its route (``nbmm.f2_matmul_route``,
    from the shapes), the list route at every slab width Wc that fits (the
    wrapper's choice is ``nbmm.f2_matmul_slab_words``), each held to both
    plain versions; the rows with a set bit below K; the bit-scan route,
    the kernel the list route replaced, on the same inputs; and the
    wrapper on ``t_all``, the transform rows before ``ge_solve_packed``
    cuts those of slots it does not write."""
    k, w = rhs.shape[1], rhs.shape[2]
    want = f2_matmul_batched_reference(rhs, t_rows)
    e_rows = max_abs_err(nbmm.f2_matmul_rows_reference(rhs, t_rows), want)
    require(e_rows == 0, f"f2_matmul_rows_reference != f2_matmul_batched_reference ({e_rows})")
    out = {"route": nbmm.f2_matmul_route(k, w), "wc_default": nbmm.f2_matmul_slab_words(k, w),
           "wc": [wc for wc in nbmm.F2_MATMUL_WORDS
                  if nbmm.f2_matmul_smem(k, wc) <= nbmm.SMEM_LIMIT],
           "real": int((word_popcount(t_rows) > 0).sum()), "rows": t_rows.shape[:2].numel()}
    for wc in out["wc"]:
        err = max_abs_err(nbmm.launch_matmul_rows(rhs, t_rows, wc), want)
        errs["f2_matmul_batched"] = max(errs["f2_matmul_batched"], err)
        require(err == 0, f"f2_matmul_batched at Wc {wc} != plain ({err})")
        out[f"wc{wc}_ms"] = cuda_ms(lambda: nbmm.launch_matmul_rows(rhs, t_rows, wc), 5)
    err = max_abs_err(nbmm.launch_matmul_scan(rhs, t_rows), want)
    errs["f2_matmul_batched"] = max(errs["f2_matmul_batched"], err)
    require(err == 0, f"f2_matmul_batched bit-scan route != plain ({err})")
    out["scan_ms"] = cuda_ms(lambda: nbmm.launch_matmul_scan(rhs, t_rows), 3)
    err = max_abs_err(f2_matmul_batched(rhs, t_all), f2_matmul_batched_reference(rhs, t_all))
    errs["f2_matmul_batched"] = max(errs["f2_matmul_batched"], err)
    require(err == 0, f"f2_matmul_batched on every row != plain ({err})")
    out["all_real"] = int((word_popcount(t_all) > 0).sum())
    out["all_ms"] = cuda_ms(lambda: f2_matmul_batched(rhs, t_all), 5)
    return out


def matmul_line(split: dict) -> str:
    """:func:`matmul_split`'s times and counts, for a log line."""
    return (", ".join(f"{wc} words {split[f'wc{wc}_ms']:.3f} ms" for wc in split["wc"])
            + f" (default Wc {split['wc_default']}); rows with a set bit {split['real']} of "
            f"{split['rows']}; the bit-scan route {split['scan_ms']:.3f} ms; every transform "
            f"row, uncut ({split['all_real']} with a set bit), {split['all_ms']:.3f} ms")


def gf_apply_split(values, rhs, mats, idx, errs: dict) -> dict:
    """``gf_apply_scatter`` at one shape: R (``nbmm.gf_apply_rows``, from E)
    and the kernel at every R, each held to both plain versions; the placed
    rows per frame; the copy alone (every target out of range, so no row
    is placed: the output must equal the values) beside a ``clone`` of the
    values; the rows alone (the kernel with its copy cut; the placed rows
    held to the plain version's)."""
    n, e = values.shape[1], mats.shape[1]
    want = gf_apply_scatter_reference(values, rhs, mats, idx)
    e_tiles = max_abs_err(nbmm.gf_apply_tiles_reference(values, rhs, mats, idx), want)
    require(e_tiles == 0, f"gf_apply_tiles_reference != gf_apply_scatter_reference ({e_tiles})")
    keep = (idx >= 0) & (idx < n)
    placed = keep.sum(dim=1)
    r = nbmm.gf_apply_rows(e)
    out = {"r": r, "tiles": -(-e // r), "placed_mean": float(placed.float().mean()),
           "placed_max": int(placed.max()), "frames_none": int((placed == 0).sum())}
    for rr in nbmm.GF_APPLY_ROWS:
        err = max_abs_err(nbmm.launch_gf_apply(values, rhs, mats, idx, rr), want)
        errs["gf_apply_scatter"] = max(errs["gf_apply_scatter"], err)
        require(err == 0, f"gf_apply_scatter at R {rr} != plain ({err})")
        out[f"r{rr}_ms"] = cuda_ms(lambda: nbmm.launch_gf_apply(values, rhs, mats, idx, rr), 5)
    none = torch.full_like(idx, n)
    require(torch.equal(nbmm.launch_gf_apply(values, rhs, mats, none, r), values),
            "gf_apply_scatter with no row placed != the values")
    out["copy_ms"] = cuda_ms(lambda: nbmm.launch_gf_apply(values, rhs, mats, none, r), 5)
    out["clone_ms"] = cuda_ms(lambda: values.clone(), 5)
    rows = nbmm.launch_gf_apply(values, rhs, mats, idx, r, copy=False)
    frames = torch.arange(values.shape[0], device=idx.device)[:, None].expand_as(idx)[keep]
    target = idx[keep].long()
    require(torch.equal(rows[frames, target], want[frames, target]),
            "gf_apply_scatter's rows alone != the plain version's placed rows")
    out["rows_ms"] = cuda_ms(
        lambda: nbmm.launch_gf_apply(values, rhs, mats, idx, r, copy=False), 5)
    return out


def gf_apply_line(split: dict) -> str:
    """:func:`gf_apply_split`'s times and counts, for a log line."""
    return (", ".join(f"R {rr} {split[f'r{rr}_ms']:.3f} ms" for rr in nbmm.GF_APPLY_ROWS)
            + f" (default R {split['r']}, {split['tiles']} tiles); placed rows per frame "
            f"{split['placed_mean']:.2f} mean, {split['placed_max']} max, "
            f"{split['frames_none']} frames none; the fused copy alone (no row placed) "
            f"{split['copy_ms']:.3f} ms, a clone of the values {split['clone_ms']:.3f} ms; the "
            f"rows alone (no copy) {split['rows_ms']:.3f} ms")


def encode_split(arrays, src, gf_order: int, errs: dict, name: str) -> dict:
    """The encode's slab route at one shape: the whole kernel at every
    slab width Wc that fits (the wrapper's choice is ``enc.slab_words``),
    each held to the wrapper's output; the slab load and the stores alone
    (the same kernel with its sums cut, ``compute=False``); a zero-padded copy
    of the source (k rows in, n out: the bound's bytes); and the per-warp
    route (the kernel this one replaced) on the same inputs."""
    words = src.view(torch.int32) if gf_order == 256 else src
    w = words.shape[2]
    want = encode_packed(arrays, src, gf_order=gf_order)
    want = want.view(torch.int32) if gf_order == 256 else want
    lv = arrays.enc_levels
    out = {"wc_default": enc.slab_words(arrays, w, gf_order), "levels": lv.levels,
           "wc": [wc for wc in enc.SLAB_WORDS
                  if enc.slab_smem(arrays, wc, gf_order) <= enc.SMEM_LIMIT]}
    for wc in out["wc"]:
        e = max_abs_err(enc.launch_slab(arrays, words, gf_order, wc), want)
        errs[name] = max(errs[name], e)
        require(e == 0, f"{name}: slab route at Wc {wc} != the default ({e})")
        out[f"wc{wc}_ms"] = cuda_ms(lambda: enc.launch_slab(arrays, words, gf_order, wc), 5)
    out["load_ms"] = cuda_ms(lambda: enc.launch_slab(
        arrays, words, gf_order, out["wc_default"], compute=False), 5)
    out["pad_ms"] = cuda_ms(
        lambda: torch.nn.functional.pad(words, (0, 0, 0, arrays.m)), 5)
    e = max_abs_err(enc.launch_warp(arrays, words, gf_order), want)
    errs[name] = max(errs[name], e)
    require(e == 0, f"{name}: per-warp route != slab route ({e})")
    out["warp_ms"] = cuda_ms(lambda: enc.launch_warp(arrays, words, gf_order), 3)
    return out


def split_line(split: dict) -> str:
    """The by-Wc times and the splits of :func:`f2_matvec_split` or
    :func:`encode_split`, for a log line."""
    head = (", ".join(f"{wc} words {split[f'wc{wc}_ms']:.3f} ms" for wc in split["wc"])
            + f" (default Wc {split['wc_default']})")
    if "clone_ms" in split:
        tail = [f"the slab load alone {split['load_ms']:.3f} ms",
                f"a clone of the values {split['clone_ms']:.3f} ms",
                f"the bit-scan route {split['scan_ms']:.3f} ms"]
    else:
        tail = [f"the slab load and the stores alone (no sums) {split['load_ms']:.3f} ms",
                f"a zero-padded copy of the source {split['pad_ms']:.3f} ms",
                f"the per-warp route {split['warp_ms']:.3f} ms", f"{split['levels']} levels"]
    return "; ".join([head, *tail])


class GEInputsNB:
    """The GF(256) GE kernels' operands for frames (values uint8 bytes,
    erased), made as ``ge_solve_wide_nb`` makes them; the elimination runs
    on the kernel."""

    def __init__(self, arrays, values, erased, emax: int):
        n = erased.shape[1]
        m = arrays.m
        self.arrays, self.values = arrays, values
        self.emax = min(emax, n)
        self.er_idx, self.real, self.nreal = erased_indices(erased, self.emax)
        self.cube = coefficient_cube_nb(arrays, self.er_idx, self.real)
        self.wa = -(-self.emax // 4)
        self.elim_out = gf256_eliminate(self.cube, self.nreal, emax=self.emax, a_words=self.wa)
        t = pivot_transforms(self.elim_out[0], self.elim_out[1], self.wa)
        self.t_top = _unpack_words_bytes(t)[:, :, :m].contiguous()
        writable = self.real & ~(self.nreal > self.emax)[:, None]
        self.idx = torch.where(writable, self.er_idx, n).to(torch.int32)
        self.rhs = gf_matvec_wide(values, arrays.vlist_idx, arrays.vlist_val,
                                  tiles=arrays.vlist_tiles)

    def kernels(self) -> dict:
        """name -> (kernel call, plain call) on these operands."""
        a, v, rhs, t, idx = self.arrays, self.values, self.rhs, self.t_top, self.idx
        kw = dict(emax=self.emax, a_words=self.wa)
        return {
            "gf256_eliminate": (lambda: gf256_eliminate(self.cube, self.nreal, **kw),
                                lambda: gf256_eliminate_reference(self.cube, self.nreal, **kw)),
            "gf_matvec_wide": (
                lambda: gf_matvec_wide(v, a.vlist_idx, a.vlist_val, tiles=a.vlist_tiles),
                lambda: gf_matvec_wide_reference(v, a.vlist_idx, a.vlist_val)),
            "gf_apply_scatter": (lambda: gf_apply_scatter(v, rhs, t, idx),
                                 lambda: gf_apply_scatter_reference(v, rhs, t, idx)),
        }

    def bounds(self) -> dict:
        """name -> :func:`bound` of each GF(256) GE kernel on these operands."""
        a, (b, n, wb) = self.arrays, self.values.shape
        m, c = self.cube.shape[1:]
        e, words = self.emax, wb // 4
        placed = self.idx < n
        t_ops = (popcount(self.t_top).sum(dim=2) + HORNER_OPS)[placed].sum()
        lists = a.vlist_idx.numel() * 4 + a.vlist_val.numel()
        return {
            "gf256_eliminate": bound(8 * b * m * c + 4 * b * e + 8 * b,
                                     elim_ops(self.cube, self.nreal, e, self.wa, gf=True)),
            "gf_matvec_wide": bound(b * wb * (n + m) + lists,
                                    b * words * (int(popcount(a.vlist_val).sum())
                                                 + m * HORNER_OPS)),
            "gf_apply_scatter": bound(b * wb * (2 * n + m) + b * e * m + 4 * b * e,
                                      words * int(t_ops)),
        }


def random_bytes(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return bench.random_bytes(shape, gen, device)


def verify_rs_pattern(b: int, n: int, seed: int, device) -> torch.Tensor:
    """``verify_rs``'s erasures (utils/verify.py:327-335): frame f < B-1
    loses 1 + round(f * 62 / (B - 2)) symbols, the last frame 64."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n), dtype=bool)
    for f in range(b):
        e = 1 + round((b - 2 and f * 62 / (b - 2)) or 0) if f < b - 1 else 64
        mask[f, rng.choice(n, e, replace=False)] = True
    return torch.from_numpy(mask).to(device)


# Phase 6c's NB escalation: B=64 frames at PER .2031 under buckets too small
# for them (emax 128, 16 frames), so ge_solve_wide_nb solves the rest.
NB_ESCALATION = dict(gf_order=256, peel_iters=10, emax=128, ge_subbatch=16, impl="vmem")


def nb_escalation(device):
    """Phase 6c's batch: (the ``NBPath`` of n2040_k1530_gf256 at B=64, the
    mask, the production branch's ``hybrid_decode(return_overflow=True)``)."""
    code = get_code("n2040_k1530_gf256")
    esc = bench.NBPath(code, b=64, wb=bench.NB["wb"], per=0.2031, seed=77, device=device)
    mask = iid_erasures((64, code.n), 0.2031, generator=esc.generator, device=device)
    prod = hybrid_decode(esc.arrays, esc.codewords, mask, return_overflow=True,
                         **NB_ESCALATION)
    return esc, mask, prod


def escalation_ge(esc, mask, prod):
    """The escalation's GE operands, as ``hybrid_decode_escalated`` makes
    them: the frames the production branch failed that keep a residual after
    the peel, at emax rounded up to 128 past the widest residual (the cube
    in device memory). Returns (peeled values, residual mask, GEInputsNB)."""
    n = esc.code.n
    pv, resid, _ = peel_decode(esc.arrays, esc.codewords, mask, max_iters=10, gf_order=256)
    cand = prod[3] & resid.any(dim=1)
    emax = min(n, -(-int(resid[cand].sum(dim=1).max()) // 128) * 128)
    return pv, resid, GEInputsNB(esc.arrays, pv[cand], resid[cand], emax)


def rs_ge(path, device):
    """The GE operands of phase 6d's RS i.i.d. batch (mask seed 17): (the
    received words, GEInputsNB)."""
    r = bench.RS
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    mask = iid_erasures((r["b"], r["n"]), r["per"], generator=gen, device=device)
    recv = path.codewords.masked_fill(mask[:, :, None], 0)
    return recv, GEInputsNB(path.arrays, recv, mask, r["n"] - r["k"])


def compare_gf_small(device, errs: dict) -> None:
    """Phase 6: the GF(256) kernels and modes against their plain versions."""
    code = get_code("n2040_k1530_gf256")
    arrays = code_arrays(code, device)
    src = random_bytes((16, code.k, 1024), 11, device)
    cw = encode_packed(arrays, src, gf_order=256)
    e = max_abs_err(cw, encode_packed_reference(arrays, src, gf_order=256))
    errs["encode_packed_gf256"] = max(errs["encode_packed_gf256"], e)
    require(e == 0, f"GF(256) encode kernel != plain ({e})")
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    mask = iid_erasures((16, code.n), bench.NB["per"], generator=gen, device=device)
    for esk in (None, code.k):
        kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=esk, gf_order=256)
        e = outputs_err(peel_decode(arrays, cw, mask, **kw),
                        peel_decode_reference(arrays, cw, mask, **kw))
        errs["peel_decode_gf256"] = max(errs["peel_decode_gf256"], e)
        require(e == 0, f"GF(256) peel kernel != plain (early_stop_k={esk}, {e})")
    log("phase 6: n2040_k1530_gf256 B=16, 1024-byte symbols: GF(256) encode and peel "
        "(early_stop_k None, k) bit-exact against the plain versions")

    rs_arrays = code_arrays(rs_code(255, 192), device)
    rs_cw = rs_encode(rs_arrays, random_bytes((64, 192, 64), 13, device))
    rs_mask = verify_rs_pattern(64, 255, 14, device)
    mask = iid_erasures((8, code.n), 0.2031, generator=gen, device=device)
    peeled_nb = peel_decode(arrays, cw[:8, :, :16].contiguous(), mask, max_iters=10, gf_order=256)
    require(bool(peeled_nb[1].any()), "the GF(256) peel left no residual for the GE")
    for name, a, values, erased, emax, in_smem in (
        ("RS(255,192) B=64", rs_arrays, rs_cw.masked_fill(rs_mask[:, :, None], 0), rs_mask,
         63, True),
        ("n2040_k1530_gf256 B=8 peeled, emax 384", arrays, peeled_nb[0], peeled_nb[1], 384,
         False),
    ):
        ge = GEInputsNB(a, values, erased, emax)
        m, c = ge.cube.shape[1:]
        require(elim.fits_shared_memory_gf256(m, c) == in_smem,
                f"{name}: a ({m}, {c})-word cube should {'' if in_smem else 'not '}fit in "
                "shared memory")
        checks = ge.kernels()
        checks["gf256_eliminate a_words=0"] = (
            lambda: gf256_eliminate(ge.cube, ge.nreal, emax=ge.emax),
            lambda: gf256_eliminate_reference(ge.cube, ge.nreal, emax=ge.emax),
        )
        if in_smem:  # the device-memory mode on the same cube
            checks["gf256_eliminate device memory"] = (
                lambda: elim.launch_kernel_gf256(ge.cube, ge.nreal, ge.emax, ge.wa, False),
                checks["gf256_eliminate"][1],
            )
        for kname, (kern, ref) in checks.items():
            e = outputs_err(as_tuple(kern()), as_tuple(ref()))
            base = kname.split()[0]
            errs[base] = max(errs[base], e)
            require(e == 0, f"{name}: {kname} kernel != plain (max abs err {e})")
        torch.cuda.synchronize()
        log(f"phase 6: {name}: cube ({m}, {c}) words in "
            f"{'shared' if in_smem else 'device'} memory; max residual {int(ge.nreal.max())}, "
            f"{int(ge.elim_out[2].sum())} failed; GF(256) GE kernels bit-exact against the "
            "plain versions")


def gf_phases(device, card: str, errs: dict, times: dict, plain: dict, bounds: dict,
              launches: dict) -> GEInputsNB:
    """Phases 6-7: the GF(256) kernels, the NB paths and RS. Returns the GE
    operands of the RS i.i.d. batch."""
    compare_gf_small(device, errs)

    # 6a: the NB main path, counted.
    code = get_code("n2040_k1530_gf256")
    nb = bench.NB
    zero_counts()
    path = bench.NBPath(code, seed=2024, device=device, **nb)
    mask, values, erased, iters, _, consumed = path.step()
    torch.cuda.synchronize()
    require(values.shape == (nb["b"], code.n, nb["wb"]) and values.dtype == torch.uint8,
            f"values {tuple(values.shape)} {values.dtype}")
    report = check_nb(path.arrays, path.codewords, mask, values, erased, iters,
                      max_iters=bench.MAX_ITERS, early_stop_k=code.k)
    log(f"phase 6a: verify {json.dumps(report)}")
    require(report["ok"], "NB main-path decode failed verification")
    frames_left = int(erased[:, : code.k].any(dim=1).sum())
    del mask, values, erased, iters, consumed
    ms = path.time_reps(5)
    counts = read_counts()
    for name in ("encode_packed_gf256", "peel_decode_gf256"):
        require(counts[name] > 0, f"the NB main path never launched the {name} kernel")
    log(f"phase 6a: NB main path {path.gbps(ms):.2f} Gbps info ({ms:.3f} ms/rep over 5 reps, "
        f"B={nb['b']} {nb['wb']}-byte symbols PER {nb['per']}, first-k early stop); frames "
        f"with source symbols left erased in the verified rep {frames_left}; launches "
        f"{counts}; on {card}")
    add_counts(launches, counts)

    # 7a: encode and peel GF(256) against their plain versions at these shapes.
    arrays = path.arrays
    src = random_bytes((nb["b"], code.k, nb["wb"]), 15, device)
    times["encode_packed_gf256"] = cuda_ms(lambda: encode_packed(arrays, src, gf_order=256), 5)
    want, plain["encode_packed_gf256"] = host_ms(
        lambda: encode_packed_reference(arrays, src, gf_order=256))
    e = max_abs_err(encode_packed(arrays, src, gf_order=256), want)
    errs["encode_packed_gf256"] = max(errs["encode_packed_gf256"], e)
    require(e == 0, f"NB main shape: GF(256) encode kernel != plain ({e})")
    bounds["encode_packed_gf256"] = encode_bound(arrays, nb["b"], nb["wb"], gf=True)
    del want
    split = encode_split(arrays, src, 256, errs, "encode_packed_gf256")
    log(f"phase 7: encode_packed_gf256 at B={nb['b']} {nb['wb']}-byte symbols: "
        f"{times['encode_packed_gf256']:.3f} ms on the slab route; by Wc: {split_line(split)}; "
        f"on {card}")
    del src
    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    mask = iid_erasures((nb["b"], code.n), nb["per"], generator=gen, device=device)
    kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=code.k, gf_order=256)
    cw = path.codewords
    times["peel_decode_gf256"] = cuda_ms(lambda: peel_decode(arrays, cw, mask, **kw), 5)
    want, plain["peel_decode_gf256"] = host_ms(
        lambda: peel_decode_reference(arrays, cw, mask, **kw))
    got = peel_decode(arrays, cw, mask, **kw)
    e = outputs_err(got, want)
    errs["peel_decode_gf256"] = max(errs["peel_decode_gf256"], e)
    require(e == 0, f"NB main shape: GF(256) peel kernel != plain ({e})")
    bounds["peel_decode_gf256"] = peel_bound(arrays, mask, got[1], nb["wb"], gf=True)
    del want, got
    split = peel_split(arrays, cw, mask, code.k, 256, errs, "peel_decode_gf256")
    log(f"phase 7: peel_decode_gf256 at B={nb['b']} {nb['wb']}-byte symbols: schedule kernel "
        f"{split['schedule_ms']:.3f} ms of {times['peel_decode_gf256']:.3f} "
        f"({100 * split['schedule_ms'] / times['peel_decode_gf256']:.1f}%), bit-exact against "
        f"its plain version; whole decode by Wc: " + ", ".join(
            f"{wc} words {split[f'wc{wc}_ms']:.3f} ms" for wc in split["wc"])
        + f" (default Wc {split['wc_default']}); the masked copy alone (0 sweeps) "
        f"{split['copy_ms']:.3f} ms, a clone of the frames {split['clone_ms']:.3f} ms; on {card}")

    # 6b: the NB hybrid with the production knobs, on the same codewords.
    path.hybrid = bench.NB_HYBRID
    zero_counts()
    mask, values, erased, iters, failed, consumed = path.step()
    torch.cuda.synchronize()
    report = check_hybrid(arrays, cw, mask, values, erased, failed,
                          peel_iters=bench.NB_HYBRID["peel_iters"], gf_order=256,
                          require_ge=False)
    log(f"phase 6b: verify {json.dumps(report)}")
    require(report["ok"], "NB hybrid decode failed verification")
    del mask, values, erased, iters, failed, consumed
    path.failed_frames = path.frames = 0
    ms = path.time_reps(3)
    counts = read_counts()
    require(counts["peel_decode_gf256"] > 0, "the NB hybrid never launched the GF(256) peel")
    log(f"phase 6b: NB hybrid {path.gbps(ms):.2f} Gbps info ({ms:.3f} ms/rep over 3 reps, "
        f"{bench.NB_HYBRID}); hybrid FER {path.fer():.4e} ({path.failed_frames}/{path.frames});"
        f" GE frames in the verified rep {report['ge_frames']} (the GE branch is the plain "
        f"ge_solve); launches {counts}; on {card}")
    add_counts(launches, counts)
    del path, cw

    # 6c: NB escalation: buckets too small, ge_solve_wide_nb on the rest.
    esc, mask, prod = nb_escalation(device)
    kw = NB_ESCALATION
    require(bool(prod[4].any()), "the production branch overflowed no frame")
    zero_counts()
    v, e_out, it, f, n_esc = hybrid_decode_escalated(esc.arrays, esc.codewords, mask, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    report = check_hybrid(esc.arrays, esc.codewords, mask, v, e_out, f, peel_iters=10,
                          gf_order=256)
    pv, resid, ge = escalation_ge(esc, mask, prod)
    emax2 = ge.emax
    c2 = ge.cube.shape[2]
    log(f"phase 6c: production branch failed {int(prod[3].sum())} ({int(prod[4].sum())} by "
        f"overflow); escalated {n_esc}; verify {json.dumps(report)}; escalation cube "
        f"({code.m}, {c2}) words, emax {emax2}; launches {counts}")
    require(report["ok"] and n_esc > 0, "NB escalation failed verification")
    require(not elim.fits_shared_memory_gf256(code.m, c2),
            "the escalation cube should live in device memory")
    require(esc.arrays.vlist_tiles is None,
            "the (2040,1530) GF(256) Vlist should take gf_matvec_wide's list route")
    for name in ("peel_decode_gf256", "gf256_eliminate", "gf_matvec_wide", "gf_apply_scatter"):
        require(counts[name] > 0, f"the NB escalation never launched the {name} kernel")
    add_counts(launches, counts)
    esc_ms = cuda_ms(lambda: hybrid_decode_escalated(esc.arrays, esc.codewords, mask, **kw), 3)
    log(f"phase 6c: gf256_eliminate on its GE operands: "
        f"{gf256_elim_line(gf256_elim_split(ge, errs))}; on {card}")
    split = gf_apply_split(ge.values, ge.rhs, ge.t_top, ge.idx, errs)
    r_ms = split[f"r{split['r']}_ms"]
    log(f"phase 6c: the escalation call {esc_ms:.3f} ms (CUDA events, 3 reps); gf_apply_scatter "
        f"on its GE operands ({ge.values.shape[0]} frames, E={ge.t_top.shape[1]}, "
        f"m={code.m}): {r_ms:.3f} ms; by R: {gf_apply_line(split)}; on {card}")
    del ge
    sel = residual_order(resid, kw["ge_subbatch"])[0]
    vs, es = pv[sel], resid[sel]
    ge_ms = cuda_ms(lambda: ge_solve(esc.arrays, vs, es, emax=kw["emax"], gf_order=256), 2)
    log(f"phase 6c: ge_solve (plain byte Gauss-Jordan) on the production bucket "
        f"({vs.shape[0]} frames, emax {kw['emax']}, {nb['wb']}-byte symbols): {ge_ms:.3f} ms "
        f"on {card}")
    del esc, v, pv, vs

    # 6d: RS(255,192) wide decode.
    r = bench.RS
    path = bench.RSPath(seed=2024, device=device, **r)
    require(path.arrays.vlist_tiles is not None,
            "the RS H should take gf_matvec_wide's dense route")
    path.pattern = verify_rs_pattern(r["b"], r["n"], 5, device)
    zero_counts()
    mask, values, erased, failed, consumed = path.step()
    torch.cuda.synchronize()
    report = check_rs(path.codewords, mask, values, erased, failed, n_minus_k=r["n"] - r["k"])
    log(f"phase 6d: verify (e = 1..63 over {r['b'] - 1} frames, one at 64) {json.dumps(report)}")
    require(report["ok"] and bool(failed[-1]) and int(failed.sum()) == 1,
            "RS decode failed verification")
    del values, erased, failed, consumed
    path.pattern = None
    path.failed_frames = path.frames = 0
    ms_iid = path.time_reps(5)
    fer_iid = (path.failed_frames, path.frames)
    path.pattern = path.systematic_pattern(r["n"] - r["k"], seed=63)
    _, values, _, failed, _ = path.step()
    require(not bool(failed.any()) and torch.equal(values, path.codewords),
            "RS e=63 systematic decode failed")
    del values, failed
    ms_63 = path.time_reps(5)
    counts = read_counts()
    for name in ("gf256_eliminate", "gf_matvec_wide", "gf_apply_scatter"):
        require(counts[name] == 12, f"RS: {name} launched {counts[name]} times for 12 decodes")
    log(f"phase 6d: RS({r['n']},{r['k']}) B={r['b']} {r['wb']}-byte payloads: i.i.d. PER "
        f"{r['per']} {path.gbps(ms_iid):.2f} Gbps info ({ms_iid:.3f} ms/batch over 5 reps, "
        f"FER {fer_iid[0] / fer_iid[1]:.4e}: {fer_iid[0]}/{fer_iid[1]}); "
        f"e=63 systematic {path.gbps(ms_63):.2f} Gbps info ({ms_63:.3f} ms/batch); launches "
        f"{counts}; on {card}")
    add_counts(launches, counts)

    # 7b: the GE kernels against their plain versions at the RS i.i.d. batch.
    recv, ge = rs_ge(path, device)
    for name, (kern, ref) in ge.kernels().items():
        times[name] = cuda_ms(kern, 5)
        want, plain[name] = host_ms(ref)
        e = outputs_err(as_tuple(kern()), as_tuple(want))
        errs[name] = max(errs[name], e)
        require(e == 0, f"RS shape: {name} kernel != plain ({e})")
        del want
    bounds.update(ge.bounds())
    log(f"phase 6d: gf256_eliminate at RS({r['n']},{r['k']}) B={r['b']} PER {r['per']}: "
        f"{gf256_elim_line(gf256_elim_split(ge, errs))}; on {card}")
    split = gf_apply_split(recv, ge.rhs, ge.t_top, ge.idx, errs)
    log(f"phase 6d: gf_apply_scatter at RS({r['n']},{r['k']}) B={r['b']} {r['wb']} bytes, PER "
        f"{r['per']}: {times['gf_apply_scatter']:.3f} ms; by R: {gf_apply_line(split)}; on {card}")
    for name in ("encode_packed_gf256", "peel_decode_gf256", "gf256_eliminate",
                 "gf_matvec_wide", "gf_apply_scatter"):
        at = (f"B={nb['b']} {nb['wb']}-byte symbols" if "gf256" in name and "elim" not in name
              else f"RS({r['n']},{r['k']}) B={r['b']} {r['wb']} bytes, PER {r['per']}")
        log(f"phase 7: {name} at {at}: kernel {times[name]:.3f} ms, plain "
            f"{plain[name]:.1f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
            f"({bounds[name]['bound_by']}: {bounds[name]['bytes']:.4g} bytes, "
            f"{bounds[name]['ops']:.4g} ops), max abs err {errs[name]} on {card}")
    return ge


def schedule_phase(device, card: str, errs: dict, times: dict, plain: dict, bounds: dict,
                   launches: dict) -> None:
    """Phase 8: the throughput command by schedule, counted and timed; the
    research kernels against their plain versions and their contracts."""
    code = get_code("n2040_k1530")
    b, w, per, k = bench.B, bench.W, bench.PER, code.k
    for schedule in SCHEDULES:
        path = bench.ThroughputPath(code, b=b, w=w, per=per, seed=2024, device=device,
                                    schedule=schedule)
        torch.cuda.synchronize()
        zero_counts()
        resid, digest = path.step()
        require(digest.shape == (w,) and digest.dtype == torch.int32,
                f"{schedule}: digest {tuple(digest.shape)} {digest.dtype}")
        ms = path.time_reps(5)
        counts = read_counts()
        name = SCHED_KERNELS.get(schedule, "peel_decode")
        require(counts[name] > 0, f"the {schedule} throughput step never launched {name}")
        add_counts(launches, counts)
        log(f"phase 8: schedule {schedule}: {path.gbps(ms):.2f} Gbps_info ({ms:.3f} ms/rep over "
            f"5 reps, B={b} W={w} PER {per}, first-k early stop); first-k residual of the first "
            f"rep {int(resid)}; {name} launches {counts[name]}; on {card}")
        del path, resid, digest

    arrays = code_arrays(code, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    cw = encode_packed(arrays, bench.random_words((b, k, w), gen, device))
    mask = iid_erasures((b, code.n), per, generator=gen, device=device)
    kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=k)
    seq_ms = cuda_ms(lambda: peel_decode(arrays, cw, mask, **kw), 5)
    values = peel_decode(arrays, cw, mask, **kw)[0]
    digest_ms = cuda_ms(lambda: values.sum(dim=(0, 1), dtype=torch.int32), 5)
    log(f"phase 8: the throughput step's digest alone (one sum over the {b}x{code.n}x{w} "
        f"decoded words): {digest_ms:.3f} ms; seq kernel alone {seq_ms:.3f} ms; on {card}")
    del values
    for schedule, name in SCHED_KERNELS.items():
        got = peel_decode(arrays, cw, mask, schedule=schedule, **kw)
        report = check_schedule(arrays, cw, mask, schedule, got=got, n_ref=64, **kw)
        log(f"phase 8: {schedule} contract on the full batch: {json.dumps(report)}")
        require(report["ok"], f"the {schedule} kernel broke its contract")
        reference = peel_decode_jacobi_reference if schedule == "jacobi" else peel_decode_reference
        want, plain[name] = host_ms(lambda: reference(arrays, cw, mask, **kw))
        e = outputs_err(got, want)
        errs[name] = max(errs[name], e)
        require(e == 0, f"{schedule} kernel != plain on the full batch ({e})")
        del want
        times[name] = cuda_ms(
            lambda: peel_decode(arrays, cw, mask, schedule=schedule, **kw), 5)
        bounds[name] = peel_bound(arrays, mask, got[1], w * 4, gf=False)
        split = order_split(arrays, mask, k, schedule, errs, name)
        log(f"phase 8: {name} at B={b} W={w}: kernel {times[name]:.3f} ms (seq {seq_ms:.3f}; "
            f"its schedule kernel {split['schedule_ms']:.3f} ms against seq's "
            f"{split['seq_schedule_ms']:.3f}, levels max {split['levels_max']}, resolutions "
            f"mean {split['resolutions_mean']:.1f}), plain {plain[name]:.1f} ms, bound "
            f"{bounds[name]['bound_ms']:.4f} ms "
            f"({bounds[name]['bound_by']}), sweeps max {int(got[2].max())} mean "
            f"{float(got[2].float().mean()):.2f}, max abs err {errs[name]} on {card}")
        del got
    xla = bench.ThroughputPath(code, b=b, w=w, per=per, seed=2024, device=device, impl="xla")
    xla.step()
    xla_ms = xla.time_reps(2)
    log(f"phase 8: impl xla (peel_decode_jacobi, plain tensors): {xla.gbps(xla_ms):.2f} "
        f"Gbps_info ({xla_ms:.3f} ms/rep over 2 reps) on {card}")
    del xla, cw, mask

    nb_code = get_code("n2040_k1530_gf256")
    nb_arrays = code_arrays(nb_code, device)
    nb_cw = encode_packed(nb_arrays, random_bytes((16, k, 1024), 19, device), gf_order=256)
    nb_mask = iid_erasures((16, nb_code.n), per, generator=gen, device=device)
    for schedule, name in SCHED_KERNELS.items():
        reference = peel_decode_jacobi_reference if schedule == "jacobi" else peel_decode_reference
        for esk in (None, k):
            kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=esk, gf_order=256)
            e = outputs_err(peel_decode(nb_arrays, nb_cw, nb_mask, schedule=schedule, **kw),
                            reference(nb_arrays, nb_cw, nb_mask, **kw))
            errs[name] = max(errs[name], e)
            require(e == 0, f"GF(256) {schedule} kernel != plain (early_stop_k={esk}, {e})")
    log("phase 8: n2040_k1530_gf256 B=16, 1024-byte symbols: the GF(256) modes of counted, "
        "grouped and jacobi (early_stop_k None, k) bit-exact against the plain versions")

    cmd = [sys.executable, "-m", "ldpc_erasure_codes_tpu_torch.utils.cli", "throughput",
           "--schedule", "counted", "--batch", str(b), "--per", str(per)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"the throughput command failed: {res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    require(out["info_gbps"] > 0 and out["symbol_bits"] == 32 * w, f"throughput output {out}")
    log(f"phase 8: `{' '.join(cmd[1:])}` printed {json.dumps(out)} on {card}")


def run_cli(argv: list[str]) -> list[dict]:
    """Run the port's CLI in this process; log its report and return its
    JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, f"cli {' '.join(argv)} returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  {line}")
    return [json.loads(x) for x in lines if x.startswith("{")]


def in_band(x: float, band: tuple) -> bool:
    return band[0] <= x <= band[1]


SIM_COMMON = ["--code", "n2040_k1530", "--pers", str(SIM_PER), "--json"]
SIM_9A = ["sim", "--decoder", "peel", "--pattern-only", "--early-stop-k", "--batch", "4096",
          "--steps-per-call", "16", "--target-errors", "150", *SIM_COMMON]
SIM_9C = ["sim", "--decoder", "hybrid", "--symbol-words", "256", "--batch", "2048",
          "--tiled-pipeline", "--max-frames", "8192", *SIM_COMMON]


def hybrid_sim_config(code):
    """9b's configuration: the JAX CLI's ``plot`` knobs (50 sweeps, emax
    256, bucket B/8) at B = 4096, 16 batches per call."""
    return sim.SimConfig(code=code.name, batch=4096, track_values=False, steps_per_call=16,
                         decoder=sim.DecoderConfig(kind="hybrid", max_iters=50, emax=256,
                                                   ge_subbatch=4096 // 8))


def sim_phase(device, card: str, launches: dict, errs: dict) -> dict:
    """Phase 9: the FER simulation at (2040,1530), PER .1875. Returns 9a's
    point."""
    argv = SIM_9A
    log(f"phase 9a: cli {' '.join(argv)}")
    (p,) = run_cli(argv)
    log(f"phase 9a: peel FER {p['fer']:.4e} (band {PEEL_FER}), RS FER {p['rs_fer']:.4e} "
        f"(band {RS_FER}), mean iterations {p['mean_iters']:.3f} (band {PEEL_ITERS}), "
        f"escalations {p['escalations']}, {p['frames']} frames, "
        f"{p['frames_per_sec']:.1f} frames/s on {card}")
    require(in_band(p["fer"], PEEL_FER), f"9a peel FER {p['fer']} outside {PEEL_FER}")
    require(in_band(p["rs_fer"], RS_FER), f"9a RS FER {p['rs_fer']} outside {RS_FER}")
    require(in_band(p["mean_iters"], PEEL_ITERS),
            f"9a mean iterations {p['mean_iters']} outside {PEEL_ITERS}")

    require((p["frames"], p["block_errors"], p["rs_block_errors"]) == RECORDED_COUNTS["9a"],
            f"9a counts {p['frames']}, {p['block_errors']}, {p['rs_block_errors']} differ from "
            f"the recorded {RECORDED_COUNTS['9a']}")

    code = get_code("n2040_k1530")
    cfg = hybrid_sim_config(code)
    torch.cuda.synchronize()
    zero_counts()
    (h,) = sim.run_fer_sweep(code, cfg, [SIM_PER], target_errors=150, device=device)
    counts = read_counts()
    require(counts["ge_rank"] > 0, "the pattern-only hybrid never launched the rank kernel")
    add_counts(launches, counts)
    log(sim.format_report(f"{code.name} hybrid", cfg, [h]))
    log(f"phase 9b: hybrid FER {h.fer:.4e} (band {HYBRID_FER}), RS FER {h.rs_fer:.4e}, mean "
        f"iterations {h.mean_iters:.3f}, ml_failed {h.ml_failed}, escalations {h.escalations}, "
        f"{h.frames} frames, {h.frames_per_sec:.1f} frames/s (plain pivot loop: "
        f"{PLAIN_LOOP_FPS['9b']}); rank kernel launches {counts['ge_rank']}; on {card}")
    require(in_band(h.fer, HYBRID_FER), f"9b hybrid FER {h.fer} outside {HYBRID_FER}")
    got = (h.frames, h.block_errors, h.ml_failed, h.escalations)
    require(got == RECORDED_COUNTS["9b"],
            f"9b counts {got} differ from the recorded {RECORDED_COUNTS['9b']}")
    # At emax 256 the failures are bucket overflows, here and in the JAX
    # package's decoder on the same masks (test_hybrid_bucket_overflow_matches_jax).
    require(h.escalations <= h.ml_failed, "9b: a frame failed by bucket size was not failed")
    # The same sweep with a column bucket no residual outgrows: what is left
    # is rank deficiency alone (the ML decoder's FER), with no escalation.
    ml_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, emax=512))
    zero_counts()
    (ml,) = sim.run_fer_sweep(code, ml_cfg, [SIM_PER], target_errors=150, max_frames=65536,
                              device=device)
    counts = read_counts()
    add_counts(launches, counts)
    log(f"phase 9b: emax 512: hybrid FER {ml.fer:.4e} ({ml.block_errors}/{ml.frames}), "
        f"ml_failed {ml.ml_failed}, escalations {ml.escalations}, {ml.frames_per_sec:.1f} "
        f"frames/s (plain pivot loop: {PLAIN_LOOP_FPS['9b emax 512']}); rank kernel launches "
        f"{counts['ge_rank']}; on {card}")
    require(ml.escalations == 0, f"9b emax 512: {ml.escalations} frames failed by bucket size")
    require(ml.fer <= h.fer, "9b: a wider column bucket raised the FER")
    got = (ml.frames, ml.block_errors, ml.ml_failed, ml.escalations)
    require(got == RECORDED_COUNTS["9b emax 512"],
            f"9b emax 512 counts {got} differ from the recorded ones")

    argv = SIM_9C
    log(f"phase 9c: cli {' '.join(argv)}")
    torch.cuda.synchronize()
    zero_counts()
    (v,) = run_cli(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    for name in ("encode_packed", "peel_decode", "f2_eliminate"):
        require(counts[name] > 0, f"the value-tracking sim never launched the {name} kernel")
    add_counts(launches, counts)
    got = (v["frames"], v["block_errors"], v["ml_failed"], v["escalations"])
    require(got == RECORDED_COUNTS["9c"],
            f"9c counts {got} differ from the recorded {RECORDED_COUNTS['9c']}")
    log(f"phase 9c: value-tracking hybrid FER {v['fer']:.4e}, RS FER {v['rs_fer']:.4e}, "
        f"escalations {v['escalations']}, ml_failed {v['ml_failed']}, mean iterations "
        f"{v['mean_iters']:.3f}, {v['frames']} frames, {v['frames_per_sec']:.1f} frames/s "
        f"({v['info_gbps']:.3f} Gbps_info); launches {counts}; on {card}")
    sim_9c_stages(device, card, errs)
    return p


def sim_9c_stages(device, card: str, errs: dict) -> None:
    """9c's stages, each timed alone by CUDA events on one batch at 9c's
    shape (the CLI's configuration: B = 2048, W = 256, PER .1875, 10 peel
    sweeps, emax 128, the whole batch in one GE, the masking fused in the
    peel kernel): the channel's mask, the source draw, the encode, the
    peel, the GE and, within it, its steps as ``ge_solve_packed`` runs them
    (``erased_indices`` with the cube build, the elimination, the transform
    gather, the dense syndrome, the apply); then the decode and one sim
    step whole. The elimination (both memory modes, with the cuts and
    without) and the apply are held to their plain versions on this
    batch."""
    cfg = cli.sim_config(cli.parser().parse_args(SIM_9C))
    d = cfg.decoder
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    shape = (cfg.batch, code.n)
    st = {"channel": cuda_ms(lambda: iid_erasures(shape, SIM_PER, generator=gen, device=device),
                             5),
          "source": cuda_ms(lambda: bench.random_words(
              (cfg.batch, code.k, cfg.symbol_words), gen, device), 5)}
    mask = iid_erasures(shape, SIM_PER, generator=gen, device=device)
    src = bench.random_words((cfg.batch, code.k, cfg.symbol_words), gen, device)
    st["encode"] = cuda_ms(lambda: encode_packed(arrays, src), 5)
    cw = encode_packed(arrays, src)
    del src
    st["peel"] = cuda_ms(lambda: peel_decode(arrays, cw, mask, max_iters=d.peel_iters), 5)
    v, e, _ = peel_decode(arrays, cw, mask, max_iters=d.peel_iters)
    st["GE"] = cuda_ms(lambda: ge_solve_packed(arrays, v, e, emax=d.emax), 3)
    emax = min(d.emax, code.n)
    wa = -(-emax // 32)

    def build():
        er_idx, real, nreal = erased_indices(e, emax)
        return er_idx, real, nreal, coefficient_cube(arrays, er_idx, real)

    st["GE: indices and cube"] = cuda_ms(build, 5)
    er_idx, real, nreal, cube = build()
    st["GE: elimination"] = cuda_ms(lambda: f2_eliminate(cube, nreal, emax=emax, a_words=wa), 5)
    r, pivrow, _ = f2_eliminate(cube, nreal, emax=emax, a_words=wa)
    st["GE: transform gather"] = cuda_ms(lambda: pivot_transforms(r, pivrow, wa), 5)
    t_rows = pivot_transforms(r, pivrow, wa)
    st["GE: dense syndrome"] = cuda_ms(
        lambda: f2_matvec_wide(v, arrays.h_words, rows=arrays.h_rows), 5)
    rhs = f2_matvec_wide(v, arrays.h_words, rows=arrays.h_rows)
    safe_idx = torch.where(real & (nreal <= emax)[:, None], er_idx, code.n).to(torch.int32)
    st["GE: apply"] = cuda_ms(lambda: f2_apply_scatter(v, rhs, t_rows, safe_idx), 5)
    elim_line_9c = elim_line(elim_split(cube, nreal, emax, wa, errs))
    err = max_abs_err(f2_apply_scatter(v, rhs, t_rows, safe_idx),
                      nbmm.f2_apply_rows_reference(v, rhs, t_rows, safe_idx))
    errs["f2_apply_scatter"] = max(errs["f2_apply_scatter"], err)
    require(err == 0, f"9c: f2_apply_scatter != plain ({err})")
    placed = int((safe_idx < code.n).sum())
    placing = int((safe_idx < code.n).any(dim=1).sum())
    resid = int(e.any(dim=1).sum())
    del v, e, cube, r, t_rows, rhs
    st["decode"] = cuda_ms(lambda: hybrid_decode(
        arrays, cw, mask, peel_iters=d.peel_iters, emax=d.emax, impl=d.impl,
        ge_subbatch=d.ge_subbatch, tiled=cfg.tiled_pipeline, return_overflow=True), 3)
    del cw, mask
    step = sim.make_sim_step(code, cfg, device=device)
    st["sim step"] = cuda_ms(lambda: step(0, SIM_PER), 3) / max(cfg.steps_per_call, 1)
    log(f"phase 9c: stages of one batch (B={cfg.batch}, W={cfg.symbol_words}, PER {SIM_PER}, "
        f"{resid} frames left for the GE), ms by CUDA events: " + "; ".join(
            f"{k} {v:.3f}" for k, v in st.items()) + f" (\"GE: ...\" are steps of \"GE\"); on "
        f"{card}")
    log(f"phase 9c: the GE's elimination {elim_line_9c}; the apply places {placed} rows of "
        f"{safe_idx.numel()} ({placing} frames of {cfg.batch} place any); both kernels equal to "
        "their plain versions")


def rank_bound(arrays, erased: torch.Tensor, emax: int) -> dict:
    """Bound of the rank check on these masks: the masks in, a flag out and
    the Clist rows of the erased symbols it builds from; the operations
    are the forward elimination's XOR word-operations, counted by replaying
    it as the kernel runs it (rows past the real block's words untouched, a
    frame stopping at its first column without a pivot, overflowing and
    empty frames doing no work), as ``elim_ops`` counts the GE's. Also
    returns the widest eliminated frame's columns (``width_max``) and the
    most column steps a frame takes (``steps_max``: its chain of dependent
    steps, the failing one included)."""
    b, n = erased.shape
    emax = min(emax, n)
    nreal = erased.sum(dim=1)
    work = (nreal > 0) & (nreal <= emax)
    col_of = erased.cumsum(dim=1) - 1
    built = erased & work[:, None] & (col_of < emax)
    nbytes = b * n + b + 4 * int((arrays.clist_len.long()[None, :] * built).sum())
    a = erased_columns(arrays, erased, emax)
    m = a.shape[1]
    nw = (nreal.clamp(max=emax) + 31) // 32
    used = torch.zeros((b, m), dtype=torch.bool, device=erased.device)
    alive = work.clone()
    frames = torch.arange(b, device=erased.device)
    total = torch.zeros((), dtype=torch.int64, device=erased.device)
    steps = torch.zeros(b, dtype=torch.int64, device=erased.device)
    for col in range(min(int(nreal[work].max()), emax) if bool(work.any()) else 0):
        live = alive & (col < nreal)
        steps += live
        colv = ((a[:, :, col >> 5] >> (col & 31)) & 1).bool() & ~used & live[:, None]
        has = colv.any(dim=1)
        alive &= has | ~live
        piv = colv.to(torch.uint8).argmax(dim=1)
        is_piv = torch.zeros_like(used)
        is_piv[frames, piv] = has
        used |= is_piv
        elim = colv & ~is_piv & has[:, None]
        total += ((nw - (col >> 5)) * elim.sum(dim=1)).sum()
        a ^= torch.where(elim[:, :, None], a[frames, piv][:, None, :], 0)
    return {**bound(nbytes, int(total)), "steps_max": int(steps.max()) if b else 0,
            "width_max": int(nreal[work].max()) if bool(work.any()) else 0}


def rank_phase(device, card: str, errs: dict, times: dict, plain: dict, bounds: dict) -> None:
    """Phase 10, rank kernel: 9b's bucket (the first 512 residual frames of
    a 4096-frame batch at PER .1875, peeled to convergence) at emax 256 and
    512 by every route, each timed (the wrapper takes "registers"; "smem"
    and "device" keep the column step of the kernel before its redesign);
    (4000,2000) i.i.d. masks at emax 128 and 256, the shapes the register
    route cannot take ("smem" and "device", timed); and a (4000,2000)
    emax-1024 batch whose matrix lives in device memory; bit-exact against
    the plain versions."""
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(91)
    mask = iid_erasures((4096, code.n), SIM_PER, generator=gen, device=device)
    e = peel_decode_mask(arrays, mask, max_iters=50)[0]
    bucket = e[residual_order(e, 512)[0]].contiguous()
    for emax in (256, 512):
        want = rank.f2_rank_check_reference(arrays, bucket, emax=emax)
        loop = ge_rank_check_reference(arrays, bucket, emax=emax)
        require(torch.equal(want, loop), f"emax {emax}: the two plain rank checks differ")
        route_ms = {}
        for route in rank.ROUTES:
            got = rank.launch_kernel(arrays, bucket, emax, route)
            e_err = max_abs_err(got, want)
            errs["ge_rank"] = max(errs["ge_rank"], e_err)
            require(e_err == 0, f"emax {emax} route {route}: rank kernel != plain")
            route_ms[route] = cuda_ms(lambda: rank.launch_kernel(arrays, bucket, emax, route), 10)
        require(rank.kernel_route(arrays.n, arrays.m, emax) == "registers",
                f"emax {emax}: the wrapper should take the register route")
        ms = cuda_ms(lambda: f2_rank_check(arrays, bucket, emax=emax), 10)
        _, plain_ms = host_ms(lambda: rank.f2_rank_check_reference(arrays, bucket, emax=emax))
        _, loop_ms = host_ms(lambda: ge_rank_check_reference(arrays, bucket, emax=emax))
        bnd = rank_bound(arrays, bucket, emax)
        nreal = bucket.sum(dim=1)
        log(f"phase 10: rank kernel on 9b's bucket ({bucket.shape[0]} frames, max residual "
            f"{int(nreal.max())}), emax {emax}: {int(want.sum())} failed "
            f"({int((nreal > emax).sum())} overflowed); widest eliminated frame "
            f"{bnd['width_max']} columns, longest chain {bnd['steps_max']} column steps; kernel "
            f"{ms:.3f} ms, {1e3 * ms / max(bnd['steps_max'], 1):.3f} us per column step; by "
            f"route " + ", ".join(f"{r} {t:.3f} ms" for r, t in route_ms.items())
            + f" (smem and device: the column step before the redesign); plain {plain_ms:.1f} "
            f"ms, ge_rank_check's pivot loop {loop_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}: {bnd['bytes']:.4g} bytes, {bnd['ops']:.4g} ops), every route "
            f"bit-exact, on {card}")
        if emax == 256:
            times["ge_rank"], plain["ge_rank"], bounds["ge_rank"] = ms, plain_ms, bnd
    big = get_code("n4000_k2000")
    big_arrays = code_arrays(big, device)
    raw_gen = torch.Generator(device=device)
    raw_gen.manual_seed(92)
    for emax, per in ((128, 0.03), (256, 0.06)):
        raw = iid_erasures((512, big.n), per, generator=raw_gen, device=device)
        require(rank.kernel_route(big.n, big.m, emax) == "smem",
                f"(4000,2000) emax {emax}: the wrapper should take the shared-memory route")
        want = rank.f2_rank_check_reference(big_arrays, raw, emax=emax)
        require(torch.equal(want, ge_rank_check_reference(big_arrays, raw, emax=emax)),
                f"(4000,2000) emax {emax}: the two plain rank checks differ")
        route_ms = {}
        for route in rank.ROUTES:
            if not rank.route_fits(route, big.n, big.m, emax):
                continue
            got = rank.launch_kernel(big_arrays, raw, emax, route)
            e_err = max_abs_err(got, want)
            errs["ge_rank"] = max(errs["ge_rank"], e_err)
            require(e_err == 0, f"(4000,2000) emax {emax} route {route}: rank kernel != plain")
            route_ms[route] = cuda_ms(
                lambda: rank.launch_kernel(big_arrays, raw, emax, route), 10)
        require(set(route_ms) == {"smem", "device"},
                f"(4000,2000) emax {emax}: routes {sorted(route_ms)}, expected smem and device")
        bnd = rank_bound(big_arrays, raw, emax)
        nreal = raw.sum(dim=1)
        log(f"phase 10: rank kernel on (4000,2000) i.i.d. masks B=512 PER {per}, emax {emax} "
            f"(the ML decoder's check; the register route takes m <= 1024): "
            f"{int(want.sum())} failed ({int((nreal > emax).sum())} overflowed); widest "
            f"eliminated frame {bnd['width_max']} columns; by route "
            + ", ".join(f"{r} {t:.3f} ms" for r, t in route_ms.items())
            + f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); bit-exact, on {card}")
    mask = iid_erasures((8, big.n), 0.44, generator=gen, device=device)
    e = peel_decode_mask(big_arrays, mask, max_iters=200)[0]
    require(rank.kernel_route(big.n, big.m, 1024) == "device",
            "a (4000,2000) emax-1024 matrix should take only the device-memory route")
    want = rank.f2_rank_check_reference(big_arrays, e, emax=1024)
    require(torch.equal(want, ge_rank_check_reference(big_arrays, e, emax=1024)),
            "(4000,2000) emax 1024: the two plain rank checks differ")
    got = f2_rank_check(big_arrays, e, emax=1024)
    e_err = max_abs_err(got, want)
    errs["ge_rank"] = max(errs["ge_rank"], e_err)
    require(e_err == 0, "(4000,2000) emax 1024: rank kernel != plain")
    nreal = e.sum(dim=1)
    log(f"phase 10: rank kernel on (4000,2000) B=8 PER .44, emax 1024, matrix in device memory:"
        f" residuals {sorted(nreal.tolist())}, {int(want.sum())} failed; bit-exact")


def channel_phase(device, card: str, errs: dict, times: dict, plain: dict, bounds: dict) -> None:
    """Phase 10, channel kernel: B=64 and the main path's shape (2040,1530),
    B=2048, W=256, against the plain version; the unfused pair
    ``iid_erasures_per64`` + ``apply_erasures`` timed beside it."""
    code = get_code("n2040_k1530")
    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    for b in (64, bench.B):
        values = bench.random_words((b, code.n, bench.W), gen, device)
        for num in (0, 9, 64):
            got = channel_apply_per64(values, 2024 + num, num)
            e_err = outputs_err(got, channel_apply_per64_reference(values, 2024 + num, num))
            errs["channel_apply_per64"] = max(errs["channel_apply_per64"], e_err)
            require(e_err == 0, f"B={b} num={num}: channel kernel != plain")
            del got
        torch.cuda.synchronize()
    ms = cuda_ms(lambda: channel_apply_per64(values, 7, 9), 10)
    _, plain_ms = host_ms(lambda: channel_apply_per64_reference(values, 7, 9))
    pair_ms = cuda_ms(lambda: apply_erasures(values, iid_erasures_per64(
        (bench.B, code.n), 9, generator=gen, device=device)), 10)
    b, n, w = values.shape
    bnd = bound(2 * b * n * w * 4 + b * n, b * n * (PHILOX_OPS + w))
    times["channel_apply_per64"], plain["channel_apply_per64"] = ms, plain_ms
    bounds["channel_apply_per64"] = bnd
    mask = channel_apply_per64(values, 7, 9)[1]
    log(f"phase 10: channel_apply_per64 at B={b} W={w}, num 9: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), unfused "
        f"iid_erasures_per64 + apply_erasures {pair_ms:.3f} ms; erased share "
        f"{float(mask.float().mean()):.5f} (9/64 = {9 / 64:.5f}); B=64 and full shape, num 0, "
        f"9, 64 bit-exact; on {card}")


def gf_matmul_phase(ge, card: str, errs: dict, times: dict, plain: dict, bounds: dict,
                    launches: dict) -> None:
    """Phase 10, ``gf_matmul_batched`` on phase 6d's RS i.i.d. batch: the
    solved rows of every frame (T . rhs), counted, against the plain version,
    against its tiles twin (``gf_matmul_tiles_reference``, the kernel's
    order) and against the rows ``gf_apply_scatter`` places."""
    zero_counts()
    x = gf_matmul_batched(ge.rhs, ge.t_top)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["gf_matmul_batched"] > 0, "the RS rows leg never launched gf_matmul_batched")
    add_counts(launches, counts)
    e_err = max_abs_err(x, gf_matmul_batched_reference(ge.rhs, ge.t_top))
    t_err = max_abs_err(x, nbmm.gf_matmul_tiles_reference(ge.rhs, ge.t_top))
    placed = gf_apply_scatter(ge.values, ge.rhs, ge.t_top, ge.idx)
    b, n, wb = ge.values.shape
    keep = ge.idx < n
    frames = torch.arange(b, device=x.device)[:, None].expand_as(ge.idx)[keep]
    rows = placed[frames, ge.idx[keep].long()]
    require(torch.equal(rows, x[keep]), "gf_matmul_batched rows differ from the placed rows")
    errs["gf_matmul_batched"] = max(errs["gf_matmul_batched"], e_err, t_err)
    require(e_err == 0, f"gf_matmul_batched kernel != plain ({e_err})")
    require(t_err == 0, f"gf_matmul_batched kernel != its tiles twin ({t_err})")
    times["gf_matmul_batched"] = cuda_ms(lambda: gf_matmul_batched(ge.rhs, ge.t_top), 5)
    _, plain["gf_matmul_batched"] = host_ms(lambda: gf_matmul_batched_reference(ge.rhs, ge.t_top))
    m, e = ge.rhs.shape[1], ge.t_top.shape[1]
    t_ops = (popcount(ge.t_top).sum(dim=2) + HORNER_OPS).sum()
    bounds["gf_matmul_batched"] = bound(b * m * wb + b * e * m + b * e * wb,
                                        (wb // 4) * int(t_ops))
    bnd = bounds["gf_matmul_batched"]
    r = nbmm.gf_apply_rows(e)
    log(f"phase 10: gf_matmul_batched at RS(255,192) B={b} {wb} bytes ({e} rows of {m}; tiles "
        f"of R = {r}, {-(-e // r)} a frame): kernel {times['gf_matmul_batched']:.3f} ms, plain "
        f"{plain['gf_matmul_batched']:.1f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}); equal to the plain version, to its tiles twin and to "
        f"gf_apply_scatter's {int(keep.sum())} placed rows; launches "
        f"{counts['gf_matmul_batched']}; on {card}")


def decoder_top_phase(device, card: str, launches: dict) -> None:
    """Phase 10b: the FPGA's data_in -> decoder chain (PARITY.md:60) at the
    main path's shape: encode -> channel_apply_per64(seed, 9) (9/64 =
    PER .1406) -> peel with first-k stop, counted and verified; then 5 reps
    (a fresh seed each) timed."""
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2024)
    src = bench.random_words((bench.B, code.k, bench.W), gen, device)
    kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=code.k)
    torch.cuda.synchronize()
    zero_counts()
    cw = encode_packed(arrays, src)
    del src
    recv, mask = channel_apply_per64(cw, 1, 9)
    values, erased, iters = peel_decode(arrays, recv, mask, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    for name in ("encode_packed", "channel_apply_per64", "peel_decode"):
        require(counts[name] > 0, f"the decoder-top leg never launched the {name} kernel")
    add_counts(launches, counts)
    require(not recv[mask].any() and torch.equal(recv[~mask], cw[~mask]),
            "the channel kernel left an erased slot nonzero or changed a kept one")
    report = check_peel(arrays, cw, mask, values, erased, iters, **kw)
    log(f"phase 10b: verify {json.dumps(report)}")
    require(report["ok"], "decoder-top decode failed verification")
    share = float(mask.float().mean())
    left = int(erased[:, : code.k].any(dim=1).sum())
    del recv, values, erased, iters

    def rep(seed=[2]):
        seed[0] += 1
        r, msk = channel_apply_per64(cw, seed[0], 9)
        return peel_decode(arrays, r, msk, **kw)[2].max()

    ms = cuda_ms(rep, 5)
    gbps = bench.B * code.k * 32 * bench.W / (ms * 1e-3) / 1e9
    log(f"phase 10b: encode -> channel_apply_per64 (num 9) -> peel, B={bench.B} W={bench.W}: "
        f"erased share {share:.5f}, frames with source symbols left {left}; channel + peel "
        f"{ms:.3f} ms/rep over 5 reps, {gbps:.2f} Gbps_info; launches {counts}; on {card}")


def parallel_phase(device, card: str, sim_9a: dict) -> None:
    """Phase 11: the parallel layer on the card: NCCL at world size 1
    (``file://`` rendezvous), the sharded 9b and 9c steps against the
    unsharded ones, ``run_fer_point(mesh=...)`` at 9a's point, the
    ``scaling`` command in a subprocess, and ``dryrun_multichip(1)``."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        multihost.initialize("cuda", init_method=f"file://{tmp}/rendezvous", world_size=1,
                             rank=0)
        mesh = default_mesh()
        code = get_code("n2040_k1530")
        cfg_9c = cli.sim_config(cli.parser().parse_args(SIM_9C))
        for name, cfg in (("9b", hybrid_sim_config(code)), ("9c", cfg_9c)):
            step = sim.make_sim_step(code, cfg, device=device)
            plain_stats = step(0, SIM_PER).to_host()
            sharded = shard_sim_step(step, mesh)(0, SIM_PER).to_host()
            require(sharded == plain_stats, f"{name}: the sharded step differs from the step")
            log(f"phase 11: {name} step sharded over NCCL (world 1) == unsharded: frames "
                f"{sharded.frames}, block errors {sharded.block_errors}, ml_failed "
                f"{sharded.ml_failed}, escalations {sharded.escalations}")
            del step
        args_9a = cli.parser().parse_args(SIM_9A)
        p = sim.run_fer_point(code, cli.sim_config(args_9a), SIM_PER, mesh=mesh, device=device,
                              target_errors=args_9a.target_errors,
                              max_frames=args_9a.max_frames)
        require(in_band(p.fer, PEEL_FER) and in_band(p.rs_fer, RS_FER)
                and in_band(p.mean_iters, PEEL_ITERS), f"11: 9a point {p} outside the bands")
        require((p.frames, p.block_errors, p.rs_block_errors)
                == (sim_9a["frames"], sim_9a["block_errors"], sim_9a["rs_block_errors"]),
                "11: run_fer_point(mesh=...) counts differ from 9a's")
        log(f"phase 11: run_fer_point(mesh=...) at 9a's point: FER {p.fer:.4e}, RS FER "
            f"{p.rs_fer:.4e}, mean iterations {p.mean_iters:.3f}, {p.frames} frames (9a's "
            f"counts), {p.frames_per_sec:.1f} frames/s")
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "ldpc_erasure_codes_tpu_torch.utils.cli", "scaling",
               "--devices", "1", "--code", "n2040_k1530", "--batch", "4096", "--per",
               str(SIM_PER)]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        require(res.returncode == 0, f"the scaling command failed: {res.stderr[-2000:]}")
        point = json.loads(res.stdout.strip().splitlines()[-1])
        require(point["devices"] == 1 and point["frames"] > 0 and point["efficiency"] == 1.0,
                f"scaling output {point}")
        log(f"phase 11: `{' '.join(cmd[1:])}` printed {json.dumps(point)} on {card}")
        dryrun_multichip(1)
        log("phase 11: dryrun_multichip(1): the four styles passed (sharded sim step; "
            "(data, lane) binary, GF(256); RS(255,192))")
    finally:
        if torch.distributed.is_initialized():
            multihost.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 12's commands (``utils/cli.py``), started together; {tmp} is a
# fresh directory.
VERIFY_CMDS = {
    "verify --quick": ["verify", "--quick", "--out", "{tmp}/verify.json"],
    "golden n2000_k1000": ["golden", "--code", "n2000_k1000", "--dir", "{tmp}/bin"],
    "golden gf256 n2040_k1530_gf256": ["golden", "--gf", "256", "--code", "n2040_k1530_gf256",
                                       "--dir", "{tmp}/nb"],
    "golden rs 255,192": ["golden", "--rs", "255,192", "--dir", "{tmp}/rs"],
}
VERIFY_TIMEOUT_S = 120


def run_together(cmds: dict, tmp: str) -> dict:
    """Start every command at once (the port's CLI, output to files in
    ``tmp``); returns name -> (return code, stdout, seconds). A command
    still running after ``VERIFY_TIMEOUT_S`` is killed, and fails the run."""
    procs, done = {}, {}
    try:
        for i, (name, argv) in enumerate(cmds.items()):
            out = open(os.path.join(tmp, f"cmd{i}.out"), "w+")
            cmd = [sys.executable, "-m", "ldpc_erasure_codes_tpu_torch.utils.cli",
                   *(a.format(tmp=tmp) for a in argv)]
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                            text=True), out, time.perf_counter())
        while len(done) < len(procs):
            for name, (proc, out, t0) in procs.items():
                if name in done:
                    continue
                secs = time.perf_counter() - t0
                if proc.poll() is not None:
                    out.seek(0)
                    done[name] = (proc.returncode, out.read(), secs)
                else:
                    require(secs < VERIFY_TIMEOUT_S, f"12: `{name}` ran past {VERIFY_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for proc, out, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return done


def verify_phase(device, card: str, launches: dict) -> None:
    """Phase 12: the full-size battery in this process, counted, and the
    ``verify --quick`` and ``golden`` commands as subprocesses."""
    require(native.have_native(), "12: the native I/O library did not build or load")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    records = run_battery(device=device)
    torch.cuda.synchronize()
    battery_s = time.perf_counter() - t0
    counts = read_counts()
    for r in records:
        log(f"phase 12: {json.dumps(r)}")
    require([r["tier"] for r in records] == list(TIERS), f"12: tiers {records}")
    for r in records:
        require(r["status"] == "PASSED", f"12: tier {r['tier']} FAILED: {json.dumps(r)}")
    hy = records[TIERS.index("hybrid_ge")]
    require(hy["ge_frames"] > hy["failed_frames"],
            f"12: hybrid_ge solved no GE frame (ge_frames {hy['ge_frames']}, failed "
            f"{hy['failed_frames']})")
    add_counts(launches, counts)
    log(f"phase 12: full battery {battery_s:.2f} s (" + ", ".join(
        f"{r['tier']} {r['elapsed_s']} s" for r in records) + f"); launches "
        f"{ {k: v for k, v in counts.items() if v} } on {card}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_verify_")
    try:
        t0 = time.perf_counter()
        done = run_together(VERIFY_CMDS, tmp)
        wall = time.perf_counter() - t0
        for name, (rc, out, secs) in done.items():
            require(rc == 0, f"12: `{name}` returned {rc}: {out[-3000:]}")
            if name.startswith("golden"):
                require("encode=PASSED decode=PASSED" in out, f"12: `{name}` printed {out}")
            log(f"phase 12: `{name}` rc 0 in {secs:.2f} s: {out.strip().splitlines()[-1]}")
        with open(os.path.join(tmp, "verify.json")) as f:
            quick = json.load(f)
        require(quick["all_passed"] and quick["backend"] == "gpu"
                and [r["tier"] for r in quick["tiers"]] == list(TIERS),
                f"12: verify --quick wrote {json.dumps(quick)}")
        log("phase 12: verify --quick tiers: " + ", ".join(
            f"{r['tier']} {r['status']} {r['elapsed_s']} s" for r in quick["tiers"])
            + f"; the four commands together {wall:.2f} s on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def paired_kernels(device, card: str) -> None:
    """``python3 chip_smoke.py --ge-kernels``: the topology syndrome at
    phase 4b's GE bucket, ``gf256_eliminate``, ``gf_matmul_batched`` and
    ``gf_apply_scatter`` at phase 6d's RS i.i.d. batch, and
    ``gf256_eliminate`` on phase 6c's escalation operands, timed through the public
    wrappers only (CUDA events, 20 calls after a warm-up), printed as one
    JSON line. Copied to the root of another checkout of the port (an
    earlier commit), the script times that checkout's kernels on the same
    operands, so that two versions can be compared in one call."""
    h = bench.HYBRID
    path = bench.HybridPath(get_code("n2040_k1530"), seed=2024, device=device, **h)
    _, values, _, sel = ge_bucket(path, device)
    vs = values[sel]
    del values
    out = {"syndrome_from_topo 4b bucket": cuda_ms(
        lambda: syndrome_from_topo(path.arrays, vs), 20)}
    del path, vs
    _, ge = rs_ge(bench.RSPath(seed=2024, device=device, **bench.RS), device)
    kw = dict(emax=ge.emax, a_words=ge.wa)
    out["gf256_eliminate RS batch"] = cuda_ms(lambda: gf256_eliminate(ge.cube, ge.nreal, **kw), 20)
    out["gf_matmul_batched RS batch"] = cuda_ms(lambda: gf_matmul_batched(ge.rhs, ge.t_top), 20)
    out["gf_apply_scatter RS batch"] = cuda_ms(
        lambda: gf_apply_scatter(ge.values, ge.rhs, ge.t_top, ge.idx), 20)
    esc, mask, prod = nb_escalation(device)
    ge = escalation_ge(esc, mask, prod)[2]
    kw = dict(emax=ge.emax, a_words=ge.wa)
    out["gf256_eliminate 6c escalation"] = cuda_ms(
        lambda: gf256_eliminate(ge.cube, ge.nreal, **kw), 20)
    log(json.dumps({"ge_kernels_ms": out, "root": ROOT, "card": card}))


def add_counts(launches: dict, counts: dict) -> None:
    for name, count in counts.items():
        launches[name] = launches.get(name, 0) + count


def main() -> None:
    device = cuda_device()
    card = card_info()
    log(f"phase 1: card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    path, build_s = _build.build()
    _build.library()
    log(f"phase 2: built {os.path.basename(path)} in {build_s:.1f} s")
    with open(path[: -len(".so")] + ".log") as f:
        print(f.read(), file=sys.stderr, flush=True)
    if sys.argv[1:] == ["--ge-kernels"]:
        paired_kernels(device, card)
        return

    errs = {name: 0 for name in KERNELS}
    compare_small(device, errs)
    compare_ge(device, errs)

    # Phase 4: the main path, counted.
    code = get_code("n2040_k1530")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    main_path = bench.MainPath(
        code, b=bench.B, w=bench.W, per=bench.PER, seed=2024, device=device
    )
    mask, values, erased, iters, consumed = main_path.step()
    torch.cuda.synchronize()
    require(values.shape == (bench.B, code.n, bench.W), f"values shape {tuple(values.shape)}")
    report = check_peel(
        main_path.arrays, main_path.codewords, mask, values, erased, iters,
        max_iters=bench.MAX_ITERS, early_stop_k=code.k,
    )
    log(f"phase 4: verify {json.dumps(report)}")
    require(report["ok"], "main-path decode failed verification")
    frames_left = int(erased[:, : code.k].any(dim=1).sum())
    log(f"phase 4: frames with source symbols left erased: {frames_left} of {bench.B}; "
        f"max sweeps {int(iters.max())}; mean erasures {float(mask.float().sum(1).mean()):.1f}")
    del mask, values, erased, iters, consumed
    ms = main_path.time_reps(bench.REPS)
    torch.cuda.synchronize()
    counts4 = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in ("encode_packed", "peel_decode"):
        require(counts4[name] > 0, f"main path never launched the {name} kernel")
    log(f"phase 4: main path {main_path.gbps(ms):.2f} Gbps info ({ms:.3f} ms/rep over "
        f"{bench.REPS} reps, B={bench.B} W={bench.W} PER {bench.PER}, first-k early stop) "
        f"on {card}; launches {counts4}; peak memory {peak_gb:.2f} GB")

    hybrid, counts4b = hybrid_phase(device, card)
    counts4c = escalation_phase(hybrid, device)
    launches = {
        name: counts4[name] + counts4b[name] + counts4c[name] for name in BINARY
    }
    for name in BINARY:
        require(launches[name] > 0, f"no path launched the {name} kernel")
    del hybrid

    # Phase 5: kernel against plain version at the main path's shapes.
    arrays = main_path.arrays
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    src = bench.random_words((bench.B, code.k, bench.W), gen, device)
    times = {"encode_packed": cuda_ms(lambda: encode_packed(arrays, src), 5)}
    want, times_plain_enc = host_ms(lambda: encode_packed_reference(arrays, src))
    e = max_abs_err(encode_packed(arrays, src), want)
    errs["encode_packed"] = max(errs["encode_packed"], e)
    require(e == 0, f"main shape: encode kernel != plain ({e})")
    del want
    split = encode_split(arrays, src, 2, errs, "encode_packed")
    log(f"phase 5: encode_packed at B={bench.B} W={bench.W}: {times['encode_packed']:.3f} ms on "
        f"the slab route; by Wc: {split_line(split)}; on {card}")
    del src
    cw = main_path.codewords
    mask = iid_erasures((bench.B, code.n), bench.PER, generator=gen, device=device)
    kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=code.k)
    times["peel_decode"] = cuda_ms(lambda: peel_decode(arrays, cw, mask, **kw), 5)
    want, times_plain_peel = host_ms(lambda: peel_decode_reference(arrays, cw, mask, **kw))
    got = peel_decode(arrays, cw, mask, **kw)
    bounds = {
        "encode_packed": encode_bound(arrays, bench.B, bench.W * 4, gf=False),
        "peel_decode": peel_bound(arrays, mask, got[1], bench.W * 4, gf=False),
    }
    e = outputs_err(got, want)
    errs["peel_decode"] = max(errs["peel_decode"], e)
    require(e == 0, f"main shape: peel kernel != plain ({e})")
    split = peel_split(arrays, cw, mask, code.k, 2, errs, "peel_decode")
    log(f"phase 5: peel_decode at B={bench.B} W={bench.W}: schedule kernel "
        f"{split['schedule_ms']:.3f} ms of {times['peel_decode']:.3f} "
        f"({100 * split['schedule_ms'] / times['peel_decode']:.1f}%), bit-exact against its "
        f"plain version; whole decode by Wc: " + ", ".join(
            f"{wc} words {split[f'wc{wc}_ms']:.3f} ms" for wc in split["wc"])
        + f" (default Wc {split['wc_default']}); the masked copy alone (0 sweeps) "
        f"{split['copy_ms']:.3f} ms, a clone of the frames {split['clone_ms']:.3f} ms; levels "
        f"max {split['levels_max']}, resolutions per frame {split['resolutions_mean']:.1f}; on "
        f"{card}")
    plain = {"encode_packed": times_plain_enc, "peel_decode": times_plain_peel}
    del main_path, cw, mask, want, got
    hybrid = bench.HybridPath(code, seed=5, device=device, **bench.HYBRID)
    ge_times, ge_plain, stages, ge_bounds = stage_times(hybrid, device, errs)
    times.update(ge_times)
    plain.update(ge_plain)
    bounds.update(ge_bounds)
    log("phase 5: hybrid step stages (ms, CUDA events): " + "; ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    h = bench.HYBRID
    for name in BINARY:
        at = (f"B={bench.B} W={bench.W}" if name in ("encode_packed", "peel_decode") else
              f"the GE bucket ({h['ge_subbatch']} frames, W={h['w']}, emax {h['emax']})")
        log(f"phase 5: {name} at {at}: kernel {times[name]:.3f} ms, "
            f"plain {plain[name]:.1f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
            f"({bounds[name]['bound_by']}), max abs err {errs[name]} on {card}")
    del hybrid

    rs_ge = gf_phases(device, card, errs, times, plain, bounds, launches)
    gf_matmul_phase(rs_ge, card, errs, times, plain, bounds, launches)
    del rs_ge
    schedule_phase(device, card, errs, times, plain, bounds, launches)
    sim_9a = sim_phase(device, card, launches, errs)
    rank_phase(device, card, errs, times, plain, bounds)
    channel_phase(device, card, errs, times, plain, bounds)
    decoder_top_phase(device, card, launches)
    parallel_phase(device, card, sim_9a)
    verify_phase(device, card, launches)

    for name, count in launches.items():
        require(count > 0, f"no path launched the {name} kernel")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **meta, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name], "plain_ms": plain[name],
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": None}
        for name, meta in KERNELS.items()
    ]}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
