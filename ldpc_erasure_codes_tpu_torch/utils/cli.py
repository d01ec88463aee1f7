"""Command-line interface of the port.

Counterpart of ``ldpc_erasure_codes_tpu/utils/cli.py`` for the subcommands

  sim         FER sweep (the MATLAB sim drivers + FPGA data_out statistics)
  throughput  decoder throughput (main.cpp:652-658 formula)
  codes       list the shipped codes
  scaling     scaling-efficiency sweep over the ranks (north star BASELINE.md:28)

with the JAX CLI's flags, defaults and output (``format_report`` then, with
``--json``, one JSON line per point; throughput prints one JSON line), and
``--device``: the CUDA card by default, ``cpu`` where the caller asks for
it. The JAX CLI falls back to its XLA path where its VMEM kernel cannot
take a shape (:131-137, :172-180); the CUDA kernels take any width, so this
CLI has no fallback. The JAX ``throughput`` flags ``--b-tile`` and
``--tiled`` (the VMEM frame tile, the tile-major layout) have no
counterpart: the port keeps the flat layout, and its kernels take any batch
and fuse the masking.

Run as ``python -m ldpc_erasure_codes_tpu_torch.utils.cli <cmd> ...``; under
``torchrun --nproc-per-node N`` (one process per card) ``sim`` shards its
step over the ranks and ``scaling`` spans them, rank 0 printing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.bench import make_throughput_step, random_words
from ldpc_erasure_codes_tpu_torch.codes.io import get_code, list_codes
from ldpc_erasure_codes_tpu_torch.utils.device import cuda_device


def resolve_device(name: str) -> torch.device:
    """``cuda`` is the first card (raises where there is none); anything
    else is taken as torch names it."""
    return cuda_device() if name == "cuda" else torch.device(name)


def sim_config(args):
    """The :class:`SimConfig` of a ``sim`` command line (cli.py:49-68)."""
    from ldpc_erasure_codes_tpu_torch.sim import ChannelConfig, DecoderConfig, SimConfig

    tiled = bool(getattr(args, "tiled_pipeline", False))
    return SimConfig(
        code=args.code,
        gf_order=args.gf,
        batch=args.batch,
        symbol_words=args.symbol_words,
        channel=ChannelConfig(kind=args.channel, per=0.0),
        decoder=DecoderConfig(
            kind=args.decoder,
            max_iters=args.max_iters,
            peel_iters=args.peel_iters,
            emax=args.emax,
            early_stop_k=args.early_stop_k,
            impl="vmem" if tiled else DecoderConfig().impl,
        ),
        seed=args.seed,
        track_values=not args.pattern_only,
        steps_per_call=args.steps_per_call,
        tiled_pipeline=tiled,
    )


@contextlib.contextmanager
def distributed(device: str):
    """Join the launcher's process group for a command (a one-rank group
    without a launcher) unless one is running, and leave it after; yields
    (this rank's device, whether this rank prints)."""
    import torch.distributed as dist

    from ldpc_erasure_codes_tpu_torch.parallel import multihost

    own = not dist.is_initialized()
    if own:
        multihost.initialize(device)
    try:
        yield multihost.device(), dist.get_rank() == 0
    finally:
        if own:
            multihost.shutdown()


def cmd_sim(args) -> int:
    from ldpc_erasure_codes_tpu_torch.sim import format_report, run_fer_sweep

    code = get_code(args.code)
    cfg = sim_config(args)
    pers = [float(p) for p in args.pers.split(",")]
    kw = dict(target_errors=args.target_errors, max_frames=args.max_frames)
    if "WORLD_SIZE" in os.environ:  # under torchrun: the step sharded over the ranks
        with distributed(args.device) as (device, report):
            points = run_fer_sweep(code, cfg, pers, device=device, **kw)
    else:
        report = True
        points = run_fer_sweep(code, cfg, pers, device=resolve_device(args.device), **kw)
    if report:
        print(format_report(args.code, cfg, points), flush=True)
        if args.json:
            for p in points:
                print(json.dumps(vars(p)), flush=True)
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_throughput(args) -> int:
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed

    device = resolve_device(args.device)
    code = get_code(args.code)
    arrays = code_arrays(code, device)
    b, w = args.batch, args.symbol_words
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cw = encode_packed(arrays, random_words((b, code.k, w), gen, device))
    step = make_throughput_step(
        code, arrays, batch=b, per=args.per, max_iters=args.max_iters, impl=args.impl,
        schedule=args.schedule,
    )
    step(gen, cw)  # warm-up: builds the kernels on first use
    _sync(device)
    t0 = time.perf_counter()
    out = None
    for _ in range(args.reps):
        out = step(gen, cw)
    _sync(device)
    dt = time.perf_counter() - t0
    del out
    fps = b * args.reps / dt
    gbps = fps * code.k * 32 * w / 1e9
    print(json.dumps({
        "code": args.code,
        "per": args.per,
        "frames_per_sec": round(fps, 1),
        "info_gbps": round(gbps, 3),
        "symbol_bits": 32 * w,
    }), flush=True)
    return 0


def cmd_scaling(args) -> int:
    """Scaling efficiency over the ranks (cli.py:284-321): in one process
    the 1-device point; under ``torchrun`` sub-meshes of the first 1, 2,
    ... ranks, rank 0 printing one JSON line per point."""
    from ldpc_erasure_codes_tpu_torch.parallel.scaling import measure_scaling
    from ldpc_erasure_codes_tpu_torch.sim import DecoderConfig, SimConfig

    code = get_code(args.code)
    cfg = SimConfig(
        code=args.code,
        batch=args.batch,
        track_values=False,
        decoder=DecoderConfig(kind=args.decoder, max_iters=args.max_iters, early_stop_k=True),
        steps_per_call=args.steps_per_call,
    )
    counts = [int(c) for c in args.devices.split(",")] if args.devices else None
    with distributed(args.device) as (device, report):
        points = measure_scaling(code, cfg, args.per, device_counts=counts, reps=args.reps,
                                 device=device)
    if report:
        for p in points:
            print(json.dumps({
                "devices": p.devices,
                "frames": p.frames,
                "seconds": round(p.seconds, 4),
                "frames_per_sec": round(p.frames_per_sec, 1),
                "efficiency": round(p.efficiency, 4),
            }), flush=True)
    return 0


def cmd_codes(_args) -> int:
    for name in list_codes():
        c = get_code(name)
        hp = c.h_dense_nb[:, c.k:]  # triangle form: registry.py:123-131
        triangular = bool((np.diagonal(hp) != 0).all() and not np.triu(hp, 1).any())
        print(f"{name}: n={c.n} k={c.k} rate={c.k / c.n:.3f} dmax={c.dmax} "
              f"gf={c.gf_order} rs=({c.rs_n},{c.rs_k}) triangular={triangular}")
    return 0


def parser() -> argparse.ArgumentParser:
    """The argument parser (the JAX CLI's flags for these subcommands, plus
    ``--device``)."""
    p = argparse.ArgumentParser(prog="ldpc_erasure_codes_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="FER sweep")
    ps.add_argument("--code", default="n2000_k1000")
    ps.add_argument("--decoder", default="hybrid", choices=["peel", "hybrid", "ml"])
    ps.add_argument("--gf", type=int, default=2, choices=[2, 256])
    ps.add_argument("--pers", default="0.3,0.35", help="comma-separated PERs")
    ps.add_argument("--channel", default="iid", choices=["iid", "per64", "gilbert_elliott"])
    ps.add_argument("--batch", type=int, default=512)
    ps.add_argument("--symbol-words", type=int, default=0)
    ps.add_argument("--max-iters", type=int, default=50)
    ps.add_argument("--peel-iters", type=int, default=10)
    ps.add_argument("--emax", type=int, default=128)
    ps.add_argument("--early-stop-k", action="store_true")
    ps.add_argument("--target-errors", type=int, default=100)
    ps.add_argument("--max-frames", type=int, default=1_000_000)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--json", action="store_true")
    ps.add_argument("--pattern-only", action="store_true",
                    help="FER fast path: evolve erasure patterns only, skip symbol values")
    ps.add_argument("--steps-per-call", type=int, default=8,
                    help="batches per call, statistics summed on the device")
    ps.add_argument("--tiled-pipeline", action="store_true",
                    help="value mode through the peel kernel with the masking fused "
                    "(forces decoder impl=vmem; requires --symbol-words)")
    ps.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ps.set_defaults(fn=cmd_sim)

    pt = sub.add_parser("throughput", help="decoder throughput")
    pt.add_argument("--code", default="n2040_k1530")
    pt.add_argument("--per", type=float, default=0.1406)
    pt.add_argument("--batch", type=int, default=512)
    pt.add_argument("--symbol-words", type=int, default=256)
    pt.add_argument("--max-iters", type=int, default=50)
    pt.add_argument("--impl", default="pallas", choices=["pallas", "xla"],
                    help="pallas: the peel kernel of --schedule; xla: the Jacobi decoder")
    pt.add_argument("--schedule", default="seq",
                    choices=["seq", "unrolled", "counted", "grouped", "jacobi"])
    pt.add_argument("--reps", type=int, default=20)
    pt.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    pt.set_defaults(fn=cmd_throughput)

    pc = sub.add_parser("codes", help="list the shipped codes")
    pc.set_defaults(fn=cmd_codes)

    psc = sub.add_parser("scaling", help="scaling-efficiency sweep over the ranks")
    psc.add_argument("--code", default="n2000_k1000")
    psc.add_argument("--decoder", default="peel", choices=["peel", "hybrid", "ml"])
    psc.add_argument("--per", type=float, default=0.3)
    psc.add_argument("--batch", type=int, default=256, help="per-device batch")
    psc.add_argument("--max-iters", type=int, default=20)
    psc.add_argument("--steps-per-call", type=int, default=4)
    psc.add_argument("--reps", type=int, default=4)
    psc.add_argument("--devices", default="", help="comma list, e.g. 1,2,4,8")
    psc.add_argument("--device", default="cuda", help="cuda (a card per rank, NCCL) or cpu "
                     "(gloo)")
    psc.set_defaults(fn=cmd_scaling)
    return p


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
