"""Scaling-efficiency measurement over the ranks.

Counterpart of ``ldpc_erasure_codes_tpu/parallel/scaling.py`` (:23-82). The
north-star target is >= 80% codewords/s scaling efficiency at >= 2 hosts
(BASELINE.json). This runs the same per-device workload on growing
sub-meshes (the first ``nd`` ranks) and reports throughput and efficiency
against linear scaling of the smallest point's rate. The Monte-Carlo step
generates its inputs on the device and only all-reduces a small counter
vector, so efficiency on real cards is expected near 1.0; over gloo on the
CPU the numbers exercise the measurement path, not an interconnect.
"""

from __future__ import annotations

import dataclasses
import time

import torch.distributed as dist

from ldpc_erasure_codes_tpu_torch.parallel.mesh import BATCH_AXIS, make_mesh, shard_sim_step


@dataclasses.dataclass
class ScalePoint:
    devices: int
    frames: int
    seconds: float
    frames_per_sec: float
    efficiency: float  # vs linear scaling of the first point's rate


def measure_scaling(
    code,
    cfg,
    per: float,
    *,
    device_counts: list[int] | None = None,
    reps: int = 4,
    device=None,
) -> list[ScalePoint]:
    """Throughput of the sharded sim step on growing sub-meshes.

    ``cfg.batch`` is the per-device batch (weak scaling: each card keeps its
    own full batch). Every rank calls this; the ranks of a sub-mesh run it,
    the others wait, and every rank meets at a barrier before each timed
    region. The points are this rank's timings: rank 0's are the report.
    ``device`` is the step's (the card by default).
    """
    from ldpc_erasure_codes_tpu_torch.sim.driver import make_sim_step

    world = dist.get_world_size()
    if device_counts is None:
        device_counts = sorted({1, 2, world // 2, world} - {0})
    step_local = make_sim_step(code, cfg, device=device)
    per_arg = int(round(per * 64)) if cfg.channel.kind == "per64" else float(per)
    points: list[ScalePoint] = []
    base_rate = None
    for nd in device_counts:
        if nd > world:
            continue
        mesh = make_mesh((nd,), (BATCH_AXIS,))
        member = mesh.get_coordinate() is not None
        if member:
            step = shard_sim_step(step_local, mesh)
            step(0, per_arg).to_host()  # warm-up: kernels built, groups connected
        dist.barrier()
        t0 = time.perf_counter()
        frames = 0
        if member:
            out = None
            for i in range(reps):
                out = step(i, per_arg)
            frames = int(out.to_host().frames) * reps
        dt = time.perf_counter() - t0
        dist.barrier()
        if not member:
            continue
        rate = frames / dt
        if base_rate is None:
            base_rate = rate
        points.append(ScalePoint(
            devices=nd,
            frames=frames,
            seconds=dt,
            frames_per_sec=rate,
            efficiency=rate / (base_rate * nd / device_counts[0]),
        ))
    return points
