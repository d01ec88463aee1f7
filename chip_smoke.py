#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it fails (exit code != 0, no result line) without them.

Phases, each fatal on failure:

1. the card: name and power limit, as ``nvidia-smi`` prints them;
2. build the CUDA kernels from ``ldpc_erasure_codes_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, bit-exact:
   (2040,1530) at B=64 and (2000,1000) at B=16, W=256; the decode with and
   without first-k early stop;
4. the main path at full width through the entry points a user calls
   (``bench.MainPath``): (2040,1530), B=2048, W=256, PER 0.1406, first-k
   early stop, 50 sweeps at most. The launch counters are zeroed just
   before and read just after; the first decode is verified bit-exactly
   (``utils/verify.py``), then 10 reps are timed with CUDA events;
5. each kernel's time against its plain version's at the main path's
   shape, with the outputs compared again.

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
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from ldpc_erasure_codes_tpu_torch.utils.device import card_info, cuda_device
from ldpc_erasure_codes_tpu_torch.utils.verify import check_peel

KERNELS = {
    "encode_packed": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/encode.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_encode.py:223",
    ),
    "peel_decode": dict(
        source="ldpc_erasure_codes_tpu_torch/csrc/peel.cu",
        replaces="ldpc_erasure_codes_tpu/ops/pallas_peel.py:1281",
    ),
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

    # Phase 4: the main path, counted.
    code = get_code("n2040_k1530")
    torch.cuda.reset_peak_memory_stats()
    encode_packed.launches = 0
    peel_decode.launches = 0
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
    launches = {"encode_packed": encode_packed.launches, "peel_decode": peel_decode.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, count in launches.items():
        require(count > 0, f"main path never launched the {name} kernel")
    log(f"phase 4: main path {main_path.gbps(ms):.2f} Gbps info ({ms:.3f} ms/rep over "
        f"{bench.REPS} reps, B={bench.B} W={bench.W} PER {bench.PER}, first-k early stop) "
        f"on {card}; launches {launches}; peak memory {peak_gb:.2f} GB")

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
    for name in KERNELS:
        log(f"phase 5: {name} at B={bench.B} W={bench.W}: kernel {times[name]:.3f} ms, "
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
