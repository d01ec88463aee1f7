#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it fails (exit code != 0, no result line) without them.

Phases, each fatal on failure:

1. the card: name and power limit, as ``nvidia-smi`` prints them;
2. build the CUDA kernels from ``ldpc_erasure_codes_tpu_torch/csrc``;
3. the encode and peel kernels against their plain PyTorch versions on
   the card, bit-exact: (2040,1530) at B=64 and (2000,1000) at B=16,
   W=256; the decode with and without first-k early stop;
3b. the hybrid decoder's GE kernels (elimination, topology syndrome, dense
   syndrome, transform rows, transform apply) against their plain versions,
   bit-exact, on peeled frames: (2040,1530) B=64 PER .2031 emax 512,
   (2000,1000) B=16 PER .3906 emax 768 (a 224 KB cube in shared memory),
   and (4000,2000) B=4 emax 1024 (the cube in device memory);
4. the main path at full width through the entry points a user calls
   (``bench.MainPath``): (2040,1530), B=2048, W=256, PER 0.1406, first-k
   early stop, 50 sweeps at most. The launch counters are zeroed just
   before and read just after; the first decode is verified bit-exactly
   (``utils/verify.py``), then 10 reps are timed with CUDA events;
4b. the hybrid path at full width (``bench.HybridPath``, the GE-hot point
   of scripts/bench_hybrid_values.py): (2040,1530), B=1024, W=256, PER
   .2031, 10 peel sweeps, emax 512, a GE bucket of 448 frames, the rows
   written back with the topology syndrome. Counters zeroed before, read
   after; the first decode verified (``check_hybrid``), then 5 reps timed;
4c. ``hybrid_decode_escalated`` through ``compact_ge_solve`` with buckets
   too small for the batch (emax 128, 64 frames), so escalation fires;
   verified, and held against the production branch on the same mask;
5. each kernel's time against its plain version's at the main path's
   shapes (phase 4 for encode and peel, phase 4b's GE bucket for the rest),
   with the outputs compared again, and the hybrid step's stages.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ldpc_erasure_codes_tpu_torch import bench
from ldpc_erasure_codes_tpu_torch.channel.erasure import iid_erasures
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import _build, elim
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.compact import residual_order
from ldpc_erasure_codes_tpu_torch.ops.elim import f2_eliminate, f2_eliminate_reference
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.ge import coefficient_cube, erased_indices, pivot_transforms
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.nbmm import (
    f2_apply_scatter,
    f2_apply_scatter_reference,
    f2_matmul_batched,
    f2_matmul_batched_reference,
    f2_matvec_wide,
    f2_matvec_wide_reference,
)
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.ops.synd import syndrome_from_topo, syndrome_from_topo_reference
from ldpc_erasure_codes_tpu_torch.utils.device import card_info, cuda_device
from ldpc_erasure_codes_tpu_torch.utils.verify import check_hybrid, check_peel

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
        source="ldpc_erasure_codes_tpu_torch/csrc/synd.cu",
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
}
# The wrapper of each kernel; ``.launches`` counts its kernel's launches.
WRAPPERS = {
    "encode_packed": encode_packed,
    "peel_decode": peel_decode,
    "f2_eliminate": f2_eliminate,
    "syndrome_from_topo": syndrome_from_topo,
    "f2_matvec_wide": f2_matvec_wide,
    "f2_matmul_batched": f2_matmul_batched,
    "f2_apply_scatter": f2_apply_scatter,
}


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


def zero_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


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
        self.rhs = syndrome_from_topo(arrays, values)

    def kernels(self) -> dict:
        """name -> (kernel call, plain call) on these operands."""
        a, v, rhs, t = self.arrays, self.values, self.rhs, self.t_rows
        kw = dict(emax=self.emax, a_words=self.wa)
        return {
            "f2_eliminate": (lambda: f2_eliminate(self.cube, self.nreal, **kw),
                             lambda: f2_eliminate_reference(self.cube, self.nreal, **kw)),
            "syndrome_from_topo": (lambda: syndrome_from_topo(a, v),
                                   lambda: syndrome_from_topo_reference(a, v)),
            "f2_matvec_wide": (lambda: f2_matvec_wide(v, a.h_words),
                               lambda: f2_matvec_wide_reference(v, a.h_words)),
            "f2_matmul_batched": (lambda: f2_matmul_batched(rhs, t),
                                  lambda: f2_matmul_batched_reference(rhs, t)),
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
        dense = f2_matvec_wide(values, arrays.h_words)
        require(torch.equal(dense, ge.rhs), f"{name}: dense and topology syndromes differ")
        failed = ge.elim_out[2]
        torch.cuda.synchronize()
        log(f"phase 3b: {name} B={b} W={bench.W} PER {per}, {sweeps} sweeps, emax {ge.emax}: "
            f"cube ({m}, {c}) "
            f"words in {'shared' if in_smem else 'device'} memory; "
            f"{int(erased.any(dim=1).sum())} residual frames, max residual "
            f"{int(ge.nreal.max())}, {int(failed.sum())} failed; GE kernels bit-exact "
            "against the plain versions")


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
        ge_subbatch=64,
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
        ge_subbatch=h["ge_subbatch"], tiled=True, static_topo=True,
    )
    both = ~f & ~f2
    require(not bool((f & ~f2).any()), "escalation failed a frame the production branch solved")
    require(torch.equal(v[both], v2[both]), "escalated and production values differ")
    log(f"phase 4c: failed frames escalated {int(f.sum())}, production branch {int(f2.sum())}; "
        "values equal on frames both solved")
    return counts


def stage_times(path, device, errs: dict) -> tuple[dict, dict, dict]:
    """Phase 5 for the GE kernels at phase 4b's shapes (the bucket of the
    first ge_subbatch residual frames), and the hybrid step's stages."""
    code, h = path.code, bench.HYBRID
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    mask = iid_erasures((h["b"], code.n), h["per"], generator=gen, device=device)
    stages = {}
    stages["peel"] = cuda_ms(
        lambda: peel_decode(path.arrays, path.codewords, mask, max_iters=h["peel_iters"]), 3)
    values, erased, _ = peel_decode(path.arrays, path.codewords, mask, max_iters=h["peel_iters"])
    sel, _, _ = residual_order(erased, h["ge_subbatch"])
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
    stages["transform gather"] = cuda_ms(
        lambda: pivot_transforms(ge.elim_out[0], ge.elim_out[1], ge.wa), 5)
    stages["syndrome"] = times["syndrome_from_topo"]
    stages["apply (rows)"] = times["f2_matmul_batched"]
    x = f2_matmul_batched(ge.rhs, ge.t_rows)
    keep = ge.idx < code.n
    frames = sel[:, None].expand_as(ge.idx)[keep]
    target = ge.idx[keep].long()
    out = values.clone()
    stages["writeback"] = cuda_ms(lambda: out.index_put_((frames, target), x[keep]), 5)
    resid = int(erased.any(dim=1).sum())
    log(f"phase 5: GE bucket {vs.shape[0]} frames ({resid} residual in the batch), max residual "
        f"{int(ge.nreal.max())}, cube {tuple(ge.cube.shape)}")
    return times, plain, stages


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
        name: counts4[name] + counts4b[name] + counts4c[name] for name in KERNELS
    }
    for name, count in launches.items():
        require(count > 0, f"no path launched the {name} kernel")
    del hybrid

    # Phase 5: kernel against plain version at the main path's shapes.
    arrays = main_path.arrays
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    src = bench.random_words((bench.B, code.k, bench.W), gen, device)
    times = {"encode_packed": cuda_ms(lambda: encode_packed(arrays, src), 3)}
    want, times_plain_enc = host_ms(lambda: encode_packed_reference(arrays, src))
    e = max_abs_err(encode_packed(arrays, src), want)
    errs["encode_packed"] = max(errs["encode_packed"], e)
    require(e == 0, f"main shape: encode kernel != plain ({e})")
    del src, want
    cw = main_path.codewords
    mask = iid_erasures((bench.B, code.n), bench.PER, generator=gen, device=device)
    kw = dict(max_iters=bench.MAX_ITERS, early_stop_k=code.k)
    times["peel_decode"] = cuda_ms(lambda: peel_decode(arrays, cw, mask, **kw), 5)
    want, times_plain_peel = host_ms(lambda: peel_decode_reference(arrays, cw, mask, **kw))
    e = outputs_err(peel_decode(arrays, cw, mask, **kw), want)
    errs["peel_decode"] = max(errs["peel_decode"], e)
    require(e == 0, f"main shape: peel kernel != plain ({e})")
    plain = {"encode_packed": times_plain_enc, "peel_decode": times_plain_peel}
    del main_path, cw, mask, want
    hybrid = bench.HybridPath(code, seed=5, device=device, **bench.HYBRID)
    ge_times, ge_plain, stages = stage_times(hybrid, device, errs)
    times.update(ge_times)
    plain.update(ge_plain)
    log("phase 5: hybrid step stages (ms, CUDA events): " + "; ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    h = bench.HYBRID
    for name in KERNELS:
        at = (f"B={bench.B} W={bench.W}" if name in ("encode_packed", "peel_decode") else
              f"the GE bucket ({h['ge_subbatch']} frames, W={h['w']}, emax {h['emax']})")
        log(f"phase 5: {name} at {at}: kernel {times[name]:.3f} ms, "
            f"plain {plain[name]:.1f} ms, max abs err {errs[name]} on {card}")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **meta, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name], "plain_ms": plain[name]}
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
