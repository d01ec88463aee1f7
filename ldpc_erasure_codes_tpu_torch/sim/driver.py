"""End-to-end Monte-Carlo FER simulation driver.

Counterpart of ``ldpc_erasure_codes_tpu/sim/driver.py`` (the reference's
simulation loops, Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:134-243
binary, Matlab/ErasureCodes_NonBinaryLDPCSim.m:154-243 GF(256)): encode ->
channel -> decode -> counters, per batch on the device, with the error-count
stopping rule on the host. The branch structure of ``_draw_source``,
``_encode``, ``_erasure_mask``, ``_decode`` and ``_decode_mask`` (:43-199)
is kept:

* ``impl="vmem"`` on wide symbols runs the sequential peel kernel
  (``peel_decode``): schedule "unrolled" when ``DecoderConfig.schedule``
  is "unrolled", else "seq", whatever other schedule the config names, as
  the JAX driver maps them (:101-112, :235-239); every other peel runs
  ``peel_decode_jacobi`` with the config's ``impl`` ("vmem" on scalar
  symbols read as "gather"), so "worklist" runs the worklist sweep and an
  ``impl`` that JAX's ``peel_decode`` refuses raises (:113-124);
* the pattern-only hybrid peels to convergence, then rank-checks the
  residual (:158-191);
* ``steps_per_call`` batches per call of the step, their statistics summed
  on the device and read by the host once per call (:283-297); the
  pattern-only peel on the card has ``csrc/peel_mask.cu`` count them into
  one buffer a call (``peel_decode_mask_stats``), the others fold each
  batch by ``batch_stats``.

Each batch draws from its own ``torch.Generator``, seeded from
(``SimConfig.seed``, call, batch, shard), so a run can be repeated. The
channel operating point is an argument of the step, so one step serves a
sweep. The step runs on one device (the CUDA card unless the caller passes
another). With a ``mesh`` (or a ``torch.distributed`` group of more than
one rank) ``run_fer_point`` and ``run_fer_sweep`` shard the step over the
ranks (:func:`..parallel.mesh.shard_sim_step`, the JAX driver's
:327-414): rank r draws shard r's streams (shard 0's are the unsharded
step's), the statistics are summed over the ranks, and the stopping rule
reads the sums, so every rank stops after the same call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from ldpc_erasure_codes_tpu_torch.channel import erasure as ch
from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode, get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays, code_arrays
from ldpc_erasure_codes_tpu_torch.ops.compact import compact_ge_rank, residual_order
from ldpc_erasure_codes_tpu_torch.ops.encode import (
    encode,
    encode_nb,
    encode_packed,
    random_bytes,
    random_words,
)
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check, ge_solve
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import (
    mask_kernel_fits,
    peel_decode_jacobi,
    peel_decode_mask,
    peel_decode_mask_stats,
)
from ldpc_erasure_codes_tpu_torch.parallel.mesh import default_mesh, shard_sim_step
from ldpc_erasure_codes_tpu_torch.sim.config import SimConfig
from ldpc_erasure_codes_tpu_torch.sim.stats import Accumulator, SimStats, batch_stats
from ldpc_erasure_codes_tpu_torch.utils.device import cuda_device

WARMUP_CALL = 0xFFFFFFF
# Odd 64-bit multiplier of the shard in a batch's seed (the golden ratio's).
SHARD_MIX = 0x9E3779B97F4A7C15


def batch_generator(seed: int, call: int, j: int, device, shard: int = 0) -> torch.Generator:
    """The generator of batch ``j`` of call ``call`` of shard ``shard`` of a
    run seeded ``seed``; shard 0 is the unsharded run's."""
    g = torch.Generator(device=device)
    g.manual_seed((((seed * 0x9E3779B1 + call) * 0x85EBCA77 + j) + shard * SHARD_MIX) % 2**63)
    return g


def source_width(cfg: SimConfig) -> int:
    """Words (binary) or bytes (GF(256)) per symbol as drawn: GF(256) byte
    symbols are drawn a whole number of words wide (the kernels take four
    bytes to a word); the statistics are mask-derived and do not change."""
    w = cfg.symbol_words
    return -(-w // 4) * 4 if (cfg.gf_order == 256 and w > 0) else w


def _draw_source(gen: torch.Generator, cfg: SimConfig, k: int, device) -> torch.Tensor:
    w = source_width(cfg)
    if cfg.gf_order == 2:
        if w == 0:
            return torch.randint(0, 2, (cfg.batch, k), dtype=torch.uint8, generator=gen,
                                 device=device)
        return random_words((cfg.batch, k, w), gen, device)
    if w == 0:
        return torch.randint(0, 256, (cfg.batch, k), dtype=torch.uint8, generator=gen,
                             device=device)
    return random_bytes((cfg.batch, k, w), gen, device)


def _encode(arrays: CodeArrays, cfg: SimConfig, source: torch.Tensor) -> torch.Tensor:
    if cfg.symbol_words > 0:
        return encode_packed(arrays, source, gf_order=cfg.gf_order)
    if cfg.gf_order == 2:
        return encode(arrays, source)
    return encode_nb(arrays, source)


def _erasure_mask(gen: torch.Generator, cfg: SimConfig, n: int, per, device) -> torch.Tensor:
    c = cfg.channel
    shape = (cfg.batch, n)
    if c.kind == "iid":
        return ch.iid_erasures(shape, per, generator=gen, device=device)
    if c.kind == "per64":
        return ch.iid_erasures_per64(shape, int(per), generator=gen, device=device)
    params = ch.GilbertElliottParams(c.ge_alpha, c.ge_beta, c.ge_transition, c.ge_bias)
    init = None
    if c.carry_state:
        # Statistically the reference's carrying of the Markov state across
        # codewords (ErasureCodes_NonBinaryLDPCSim.m:191-198): each frame's
        # chain starts in the steady-state distribution.
        p_bad = (1.0 / c.ge_bias) / (1.0 + 1.0 / c.ge_bias)
        init = (torch.rand((cfg.batch,), generator=gen, device=device) < p_bad).to(torch.int32)
    mask, _ = ch.gilbert_elliott_erasures(cfg.batch, n, params, init, generator=gen,
                                          device=device)
    return mask


def _decode(arrays: CodeArrays, cfg: SimConfig, values: torch.Tensor, erased: torch.Tensor,
            k: int):
    """Value decode: (values, erased, iters, failed, overflow); failed and
    overflow are None for the peel."""
    d = cfg.decoder
    early = k if d.early_stop_k else None
    if d.kind == "peel":
        kw = dict(gf_order=cfg.gf_order, max_iters=d.max_iters, early_stop_k=early)
        if d.impl == "vmem" and values.dim() == 3:
            schedule = "unrolled" if d.schedule == "unrolled" else "seq"
            v, e, iters = peel_decode(arrays, values, erased, schedule=schedule, **kw)
        else:
            impl = "gather" if d.impl == "vmem" else d.impl
            v, e, iters = peel_decode_jacobi(arrays, values, erased, impl=impl, **kw)
        return v, e, iters, None, None
    if d.kind == "hybrid":
        return hybrid_decode(
            arrays, values, erased, gf_order=cfg.gf_order, peel_iters=d.peel_iters,
            emax=d.emax, impl=d.impl, ge_subbatch=d.ge_subbatch, tiled=cfg.tiled_pipeline,
            static_topo=d.schedule == "unrolled", return_overflow=True,
        )
    v, e, failed = ge_solve(arrays, values, erased, emax=d.emax, gf_order=cfg.gf_order)
    ov = erased.sum(dim=1) > min(d.emax, erased.shape[1])
    return v, e, torch.zeros_like(failed, dtype=torch.int32), failed, ov


def _decode_mask(arrays: CodeArrays, cfg: SimConfig, erased: torch.Tensor, k: int):
    """Pattern-only decode: (residual mask, iters, failed, overflow)."""
    d = cfg.decoder
    early = k if d.early_stop_k else None
    if d.kind == "peel":
        e, iters = peel_decode_mask(arrays, erased, max_iters=d.max_iters, early_stop_k=early)
        return e, iters, None, None
    if d.kind == "hybrid":
        # Peel to convergence before the rank check: ML solvability does
        # not depend on how much peeling precedes the elimination (peeling
        # is partial elimination of the same system), so the FER equals the
        # reference's peel-10-then-GE at a far smaller residual. The bucket
        # overflow flags are another matter: the value path eliminates after
        # only peel_iters sweeps, so its residuals are larger (:161-168).
        e, iters = peel_decode_mask(arrays, erased, max_iters=d.max_iters)
        failed = torch.zeros((e.shape[0],), dtype=torch.bool, device=e.device)
        if bool(e.any()):
            if d.ge_subbatch > 0:
                failed = compact_ge_rank(arrays, e, emax=d.emax, f_max=d.ge_subbatch,
                                         gf_order=cfg.gf_order)
            else:
                failed = ge_rank_check(arrays, e, emax=d.emax, gf_order=cfg.gf_order)
        ov = e.sum(dim=1) > min(d.emax, e.shape[1])
        if d.ge_subbatch > 0:
            ov |= residual_order(e, d.ge_subbatch)[2]
        return e & failed[:, None], iters, failed, ov
    failed = ge_rank_check(arrays, erased, emax=d.emax, gf_order=cfg.gf_order)
    ov = erased.sum(dim=1) > min(d.emax, erased.shape[1])
    iters = torch.zeros((erased.shape[0],), dtype=torch.int32, device=erased.device)
    return erased & failed[:, None], iters, failed, ov


def make_sim_step(
    code: LDPCCode | str, cfg: SimConfig, *, device: torch.device | str | None = None
) -> Callable[..., SimStats]:
    """The simulation step ``step(call, per, shard=0) -> SimStats``:
    ``steps_per_call`` batches, their statistics summed on the device;
    ``shard`` selects independent random streams (the rank's, when
    sharded).

    ``per`` is the erasure probability (iid) or the /64 numerator (per64);
    the Gilbert-Elliott channel ignores it (its point lives in the config).
    ``device`` defaults to the CUDA card (raises where there is none).
    """
    if isinstance(code, str):
        code = get_code(code)
    if cfg.gf_order == 256 and code.gf_order != 256:
        code = code.lift_to_gf256(seed=cfg.seed)
    device = cuda_device() if device is None else torch.device(device)
    arrays = code_arrays(code, device)
    n, k = code.n, code.k
    d = cfg.decoder
    max_hist = d.max_iters if d.kind == "peel" else d.peel_iters
    # The pattern-only peel on the card reads nothing of its outputs but
    # their counts: the mask kernel counts them itself, into one buffer a
    # call, in place of batch_stats and the batches' adds.
    counts_on_card = (d.kind == "peel" and not cfg.track_values and device.type == "cuda"
                      and mask_kernel_fits(arrays, code.rs_n))

    def step_once(gen: torch.Generator, per) -> SimStats:
        mask = _erasure_mask(gen, cfg, n, per, device)
        if cfg.track_values:
            cw = _encode(arrays, cfg, _draw_source(gen, cfg, k, device))
            # The flat handoff of the tiled pipeline: the peel kernel fuses
            # the masking, so the zeroing pass is skipped.
            recv = cw if cfg.tiled_pipeline else ch.apply_erasures(cw, mask)
            _, e_out, iters, failed, overflow = _decode(arrays, cfg, recv, mask, k)
        else:
            e_out, iters, failed, overflow = _decode_mask(arrays, cfg, mask, k)
        return batch_stats(
            mask, e_out, iters, failed, k, code.rs_n, code.rs_k, max_hist,
            count_all_symbols=cfg.decoder.count_all_symbols, overflow=overflow,
        )

    def step(call: int, per, shard: int = 0) -> SimStats:
        batches = range(max(cfg.steps_per_call, 1))
        if counts_on_card:
            flat = torch.zeros((len(SimStats._fields) + max_hist,), dtype=torch.int64,
                               device=device)
            for j in batches:
                gen = batch_generator(cfg.seed, call, j, device, shard)
                peel_decode_mask_stats(
                    arrays, _erasure_mask(gen, cfg, n, per, device), flat,
                    max_iters=d.max_iters, early_stop_k=k if d.early_stop_k else None,
                    k_count=n if d.count_all_symbols else k, rs_n=code.rs_n, rs_k=code.rs_k,
                )
            return SimStats.from_flat(flat)
        acc = None
        for j in batches:
            s = step_once(batch_generator(cfg.seed, call, j, device, shard), per)
            acc = s if acc is None else acc + s
        return acc

    return step


@dataclasses.dataclass
class FERPoint:
    """One operating point of a FER sweep (one row of the paper's Table I,
    Latex/Milcom_2022_ErasureCodes.tex:195-210). ``escalations`` (frames
    failed by the GE buckets' size) is the port's addition."""

    per: float
    frames: int
    block_errors: int
    rs_block_errors: int
    fer: float
    rs_fer: float
    measured_per: float
    mean_iters: float
    ml_failed: int
    seconds: float
    frames_per_sec: float
    info_gbps: float
    escalations: int = 0


def symbol_bits(cfg: SimConfig) -> int:
    if cfg.symbol_words == 0:
        return 1 if cfg.gf_order == 2 else 8
    return cfg.symbol_words * (32 if cfg.gf_order == 2 else 8)


def _sharded(step, mesh):
    """``step`` sharded over ``mesh``, or over every rank when none is given
    and ``torch.distributed`` runs more than one; else ``step``."""
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = default_mesh()
    return step if mesh is None else shard_sim_step(step, mesh)


def run_fer_point(
    code: LDPCCode | str,
    cfg: SimConfig,
    per: float,
    *,
    target_errors: int = 100,
    max_frames: int = 1_000_000,
    mesh=None,
    step=None,
    warmup: bool = True,
    device: torch.device | str | None = None,
) -> FERPoint:
    """Simulate one operating point with error-count-targeted stopping:
    calls run while fewer than ``max_frames`` frames and fewer than
    ``target_errors`` block errors are counted. The time covers the calls
    after the warm-up, each ending in its host read.

    When ``mesh`` is given (or ``torch.distributed`` runs more than one
    rank) the step is sharded over it; frames and errors are counted over
    all ranks. A given ``step`` is used as it is.
    """
    if isinstance(code, str):
        code = get_code(code)
    if step is None:
        step = _sharded(make_sim_step(code, cfg, device=device), mesh)
    per_arg = int(round(per * 64)) if cfg.channel.kind == "per64" else float(per)
    acc = Accumulator()
    if warmup:
        step(WARMUP_CALL, per_arg).to_host()
    t0 = time.perf_counter()
    i = 0
    while acc.frames < max_frames and acc.block_errors < target_errors:
        acc.add(step(i, per_arg))
        i += 1
    dt = time.perf_counter() - t0
    fps = acc.frames / dt if dt > 0 else 0.0
    return FERPoint(
        per=float(per),
        frames=acc.frames,
        block_errors=acc.block_errors,
        rs_block_errors=acc.rs_block_errors,
        fer=acc.fer,
        rs_fer=acc.rs_fer,
        measured_per=acc.erased_symbols / max(acc.frames * code.n, 1),
        mean_iters=acc.mean_iters,
        ml_failed=acc.ml_failed,
        seconds=dt,
        frames_per_sec=fps,
        info_gbps=fps * code.k * symbol_bits(cfg) / 1e9,
        escalations=acc.escalations,
    )


def run_fer_sweep(
    code: LDPCCode | str,
    cfg: SimConfig,
    pers: list[float],
    *,
    target_errors: int = 100,
    max_frames: int = 1_000_000,
    mesh=None,
    device: torch.device | str | None = None,
) -> list[FERPoint]:
    """Sweep PER operating points with one step, sharded as
    :func:`run_fer_point` shards it."""
    if isinstance(code, str):
        code = get_code(code)
    step = _sharded(make_sim_step(code, cfg, device=device), mesh)
    return [
        run_fer_point(code, cfg, p, target_errors=target_errors, max_frames=max_frames,
                      step=step)
        for p in pers
    ]


def format_report(code_name: str, cfg: SimConfig, points: list[FERPoint]) -> str:
    """Render a sweep in the paper's Table-I format
    (Latex/Milcom_2022_ErasureCodes.tex:195-210)."""
    lines = [
        f"# FER sweep — code={code_name} gf={cfg.gf_order} decoder={cfg.decoder.kind} "
        f"channel={cfg.channel.kind} batch={cfg.batch} symbol_bits={symbol_bits(cfg)}",
        f"{'PER':>8} {'frames':>12} {'errs':>7} {'FER':>10} {'RS FER':>10} "
        f"{'meas PER':>9} {'iters':>6} {'fps':>12} {'Gbps':>8}",
    ]
    for p in points:
        lines.append(
            f"{p.per:8.4f} {p.frames:12d} {p.block_errors:7d} {p.fer:10.3e} "
            f"{p.rs_fer:10.3e} {p.measured_per:9.4f} {p.mean_iters:6.2f} "
            f"{p.frames_per_sec:12.1f} {p.info_gbps:8.3f}"
        )
    return "\n".join(lines)
