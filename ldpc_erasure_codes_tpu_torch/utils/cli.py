"""Command-line interface of the port.

Counterpart of ``ldpc_erasure_codes_tpu/utils/cli.py`` for the subcommands

  sim         FER sweep (the MATLAB sim drivers + FPGA data_out statistics)
  throughput  decoder throughput (main.cpp:652-658 formula)
  codes       list the shipped codes
  scaling     scaling-efficiency sweep over the ranks (north star BASELINE.md:28)
  stream      UDP loopback streaming demo (encoder_VITA_in_UDP_out datapath)
  plot        FER curve sweep -> semilogy PNG (MPA vs hybrid vs analytic RS)
  census      4/6/8-cycle census of a code (Hcyclefinder)
  gen         construct a girth-8 code and save it (.npz)
  golden      generate + verify golden vector files (the MATLAB<->OpenCL
              cross-validation protocol)
  verify      the PASSED/FAILED decode verification battery

with the JAX CLI's flags, defaults and output (``format_report`` then, with
``--json``, one JSON line per point; throughput prints one JSON line), and
``--device``: the CUDA card by default, ``cpu`` where the caller asks for
it (``verify`` keeps JAX's ``--cpu`` flag instead; JAX's ``--fence-gate``
tunes a TPU program the port does not have, and is refused). The JAX CLI
falls back to its XLA path where its VMEM kernel cannot take a shape
(:131-137, :172-180); the CUDA kernels take any width, so this CLI has no
fallback. The JAX ``throughput`` flags ``--b-tile`` and ``--tiled`` (the
VMEM frame tile, the tile-major layout) have no counterpart: the port keeps
the flat layout, and its kernels take any batch and fuse the masking.
``plot`` needs matplotlib for its PNG: without it the sweeps run and print,
then the command says so on stderr and exits 2.

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

from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures
from ldpc_erasure_codes_tpu_torch.codes.io import get_code, list_codes
from ldpc_erasure_codes_tpu_torch.ops.peel import SCHEDULES, peel_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi
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


def cmd_throughput(args) -> int:
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, random_words

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


def cmd_stream(args) -> int:
    """End-to-end UDP loopback streaming demo (cli.py:324-355): encode ->
    lossy reordered datagrams -> reorder buffer -> batched decode on
    ``--device`` -> bit-exact verification (reference datapath:
    OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136). One JSON
    line with JAX's keys; 0 when every block was recovered or failed."""
    from ldpc_erasure_codes_tpu_torch.utils.udp import loopback_demo

    r = loopback_demo(
        args.code,
        blocks=args.blocks,
        symbol_words=args.symbol_words,
        loss=args.loss,
        shuffle=not args.in_order,
        seed=args.seed,
        assembler=args.assembler,
        vita=args.vita,
        device=resolve_device(args.device),
    )
    out = {
        "blocks": r.blocks,
        "packets_sent": r.packets_sent,
        "packets_received": r.packets_received,
        "blocks_recovered": r.blocks_recovered,
        "blocks_failed": r.blocks_failed,
        "packets_per_sec": round(r.packets_per_sec, 1),
        "payload_gbps": round(r.payload_gbps, 3),
        "transfer_complete": r.transfer_complete,
        "assembler": r.stats,
    }
    if r.vita_stats is not None:
        out["vita"] = r.vita_stats
    print(json.dumps(out), flush=True)
    return 0 if r.blocks_recovered + r.blocks_failed == r.blocks else 1


def cmd_plot(args) -> int:
    """FER curve sweep -> semilogy PNG (cli.py:233-281): the pattern-only
    peel and hybrid sweeps on ``--device``, each report printed, then the
    plot. Without matplotlib it prints why ``--out`` was not written to
    stderr and returns 2; it returns 0 only with the PNG written."""
    import importlib.util

    from ldpc_erasure_codes_tpu_torch.sim import (
        DecoderConfig,
        SimConfig,
        format_report,
        run_fer_sweep,
    )

    device = resolve_device(args.device)
    code = get_code(args.code)
    pers = [float(p) for p in args.pers.split(",")]
    common = dict(code=args.code, batch=args.batch, track_values=False,
                  steps_per_call=args.steps_per_call)
    sweep = dict(target_errors=args.target_errors, max_frames=args.max_frames, device=device)
    peel_cfg = SimConfig(**common,
                         decoder=DecoderConfig(kind="peel", max_iters=50, early_stop_k=True))
    peel_pts = run_fer_sweep(code, peel_cfg, pers, **sweep)
    print(format_report(f"{args.code} MPA", peel_cfg, peel_pts), flush=True)
    hyb_cfg = SimConfig(**common, decoder=DecoderConfig(
        kind="hybrid", max_iters=50, emax=args.emax, ge_subbatch=args.batch // 8))
    hyb_pts = run_fer_sweep(code, hyb_cfg, pers, **sweep)
    print(format_report(f"{args.code} hybrid", hyb_cfg, hyb_pts), flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        print(f"plot: matplotlib is not installed, so {args.out} was not written",
              file=sys.stderr, flush=True)
        return 2
    from ldpc_erasure_codes_tpu_torch.sim.plot import plot_fer_curves

    plot_fer_curves(
        peel_pts,
        title=f"{args.code}: FER vs raw erasure rate",
        rs_analytic=(code.rs_n, code.rs_k) if code.rs_n else None,
        extra_series={"LDPC hybrid MPA+ML": hyb_pts},
        out_path=args.out,
    )
    print(f"wrote {args.out}", flush=True)
    return 0


def _triangular(c) -> bool:
    """H[:, k:] lower triangular with a nonzero diagonal (registry.py:123-131)."""
    hp = c.h_dense_nb[:, c.k:]
    return bool((np.diagonal(hp) != 0).all() and not np.triu(hp, 1).any())


def cmd_codes(_args) -> int:
    for name in list_codes():
        c = get_code(name)
        print(f"{name}: n={c.n} k={c.k} rate={c.k / c.n:.3f} dmax={c.dmax} "
              f"gf={c.gf_order} rs=({c.rs_n},{c.rs_k}) triangular={_triangular(c)}")
    return 0


def _parse_profile(s: str):
    """'102x6,30x5' -> [(102, 6), (30, 5)] (cli.py:29-35)."""
    out = []
    for part in s.split(","):
        cnt, deg = part.lower().split("x")
        out.append((int(cnt), int(deg)))
    return out


def cmd_census(args) -> int:
    from ldpc_erasure_codes_tpu_torch.codes import cycle_census, load_code

    code = load_code(args.code) if args.code.endswith(".npz") else get_code(args.code)
    cen = cycle_census(code)
    n4, n6, n8 = cen.totals()
    print(f"{code.name}: 4-cycles={n4} 6-cycles={n6} 8-cycles={n8} "
          f"girth>=8: {cen.girth_at_least_8}")
    return 0


def cmd_gen(args) -> int:
    from ldpc_erasure_codes_tpu_torch.codes import (
        cycle_census,
        gen_column_wise,
        gen_row_wise,
        save_code,
    )

    prof_c = _parse_profile(args.profile_c)
    prof_v = _parse_profile(args.profile_v)
    t0 = time.time()
    if args.kind == "row":
        code = gen_row_wise(prof_c, prof_v, seed=args.seed, max_tries=args.max_tries)
    else:
        code = gen_column_wise(prof_c, prof_v, systematic=not args.non_systematic,
                               seed=args.seed, max_tries=args.max_tries)
    cen = cycle_census(code)
    print(f"built {code.name} in {time.time() - t0:.1f}s; census 4/6/8 = {cen.totals()}; "
          f"triangular={_triangular(code)}")
    if args.out:
        save_code(code, args.out)
        print(f"saved to {args.out}")
    return 0


def cmd_golden(args) -> int:
    """Generate a golden set with the NumPy oracle and verify it with the
    port's encoder and decoders on ``--device`` (cli.py:416-452)."""
    from ldpc_erasure_codes_tpu_torch.utils import golden

    device = resolve_device(args.device)
    if args.rs:
        n, k = (int(x) for x in args.rs.split(","))
        gs = golden.generate_golden_rs(n, k, args.dir, frames=args.frames, per=args.per,
                                       seed=args.seed)
        print(f"wrote {gs.frames} golden RS frames to {gs.directory}")
        passed, report = golden.verify_golden_rs(n, k, args.dir, device=device,
                                                 words=args.symbol_words)
        print(report)
        return 0 if passed else 1

    code = get_code(args.code)
    if args.gf == 256:
        code = code.lift_to_gf256() if code.gf_order == 2 else code
        gs = golden.generate_golden_nb(code, args.dir, frames=args.frames, per=args.per,
                                       seed=args.seed)
        print(f"wrote {gs.frames} golden NB frames to {gs.directory}")
        passed, report = golden.verify_golden_nb(code, args.dir, device=device,
                                                 words=args.symbol_words)
    else:
        gs = golden.generate_golden(code, args.dir, frames=args.frames, per=args.per,
                                    seed=args.seed)
        print(f"wrote {gs.frames} golden frames to {gs.directory}")
        passed, report = golden.verify_golden(code, args.dir, device=device,
                                              words=args.symbol_words)
    print(report)
    return 0 if passed else 1


def cmd_verify(args) -> int:
    """The PASSED/FAILED verification battery (utils/verify.py,
    cli.py:455-493): one JSON line per tier, then ``VERIFY: ALL PASSED`` or
    ``VERIFY: FAILURES``; 0 only if every tier passed. On the card unless
    ``--cpu``; it raises where there is no card."""
    from ldpc_erasure_codes_tpu_torch.utils.verify import run_battery

    if args.fence_gate:
        print("verify: --fence-gate tunes the TPU's constant-topology peel program, which "
              "the CUDA port does not have; run without it", file=sys.stderr)
        return 2
    device = torch.device("cpu") if args.cpu else resolve_device("cuda")
    results = run_battery(device=device, quick=args.quick)
    for r in results:
        print(json.dumps(r), flush=True)
    ok = all(r["status"] == "PASSED" for r in results)
    print(f"VERIFY: {'ALL PASSED' if ok else 'FAILURES'}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"backend": "cpu" if args.cpu else "gpu", "all_passed": ok,
                       "tiers": results}, f, indent=1)
    return 0 if ok else 1


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

    pst = sub.add_parser("stream", help="UDP loopback streaming demo")
    pst.add_argument("--code", default="n2000_k1000")
    pst.add_argument("--blocks", type=int, default=8)
    pst.add_argument("--symbol-words", type=int, default=2)
    pst.add_argument("--loss", type=float, default=0.1)
    pst.add_argument("--in-order", action="store_true")
    pst.add_argument("--assembler", default="auto", choices=["auto", "python"])
    pst.add_argument("--vita", action="store_true",
                     help="source symbols arrive as a VITA-49 stream over UDP first "
                     "(the reference encoder's ingest)")
    pst.add_argument("--seed", type=int, default=0)
    pst.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    pst.set_defaults(fn=cmd_stream)

    pp = sub.add_parser("plot", help="FER curve sweep -> PNG")
    pp.add_argument("--code", default="n2040_k1530")
    pp.add_argument("--pers", default="0.1406,0.1562,0.1719,0.1875,0.2031")
    pp.add_argument("--batch", type=int, default=4096)
    pp.add_argument("--steps-per-call", type=int, default=16)
    pp.add_argument("--target-errors", type=int, default=100)
    pp.add_argument("--max-frames", type=int, default=1_000_000)
    pp.add_argument("--emax", type=int, default=256)
    pp.add_argument("--out", default="fer_curve.png")
    pp.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    pp.set_defaults(fn=cmd_plot)

    pn = sub.add_parser("census", help="cycle census")
    pn.add_argument("--code", default="n2000_k1000")
    pn.set_defaults(fn=cmd_census)

    pg = sub.add_parser("gen", help="construct a girth-8 code")
    pg.add_argument("--kind", default="row", choices=["row", "col"])
    pg.add_argument("--profile-c", required=True, help="e.g. 102x6")
    pg.add_argument("--profile-v", required=True, help="e.g. 204x3")
    pg.add_argument("--non-systematic", action="store_true")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--max-tries", type=int, default=200)
    pg.add_argument("--out", default="")
    pg.set_defaults(fn=cmd_gen)

    pvf = sub.add_parser("verify", help="PASSED/FAILED decode verification battery")
    pvf.add_argument("--quick", action="store_true")
    pvf.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    pvf.add_argument("--fence-gate", action="store_true",
                     help="JAX's TPU-only option; refused here")
    pvf.add_argument("--out", default=None)
    pvf.set_defaults(fn=cmd_verify)

    pv = sub.add_parser("golden", help="golden-vector generate + verify")
    pv.add_argument("--code", default="n2000_k1000")
    pv.add_argument("--gf", type=int, default=2, choices=[2, 256])
    pv.add_argument("--rs", default="", help="RS golden instead: 'n,k'")
    pv.add_argument("--dir", required=True)
    pv.add_argument("--frames", type=int, default=4)
    pv.add_argument("--per", type=float, default=0.2)
    pv.add_argument("--symbol-words", type=int, default=8)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    pv.set_defaults(fn=cmd_golden)
    return p


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
