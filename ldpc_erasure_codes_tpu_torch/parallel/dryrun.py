"""Single-device entry and multi-device dry run of the port.

Counterpart of ``__graft_entry__.py``. :func:`entry` returns the flagship
step: one full Monte-Carlo simulation step (encode -> erasure channel ->
hybrid peel + ML decode -> counters) on the production (2040, 1530) code,
with its example arguments.

:func:`dryrun_multichip` runs the JAX dry run's four styles
(``__graft_entry__.py:49-154``) over the process group, on tiny shapes:

1. the sharded sim step on the 1-D data mesh (summed statistics);
2. the (data, lane) mesh: each rank holds its block of the batch and of the
   packed word axis (:func:`.mesh.shard_batch`), the mask drawn identically
   across a lane group; binary encode -> channel -> ``hybrid_decode``, and a
   frame is bad when any lane of it differs, so bad frames equal failed ones;
3. the same on a GF(256) toy code;
4. RS(255, 192) on the same mesh with 1 + 7f mod 63 erasures in frame f:
   every frame decodes exactly.

Each style's counts are summed with ``all_reduce`` and every rank asserts
on them. Call :func:`.multihost.initialize` first (one process per card, or
gloo with ``device="cpu"``); each process draws the global inputs from the
same seeds and keeps its block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ldpc_erasure_codes_tpu_torch.parallel import multihost
from ldpc_erasure_codes_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    LANE_AXIS,
    make_mesh,
    shard_batch,
    shard_sim_step,
)


def entry(device=None):
    """The flagship sim step (hybrid, 10 peel sweeps, emax 64, B = 32 on
    (2040, 1530)) and its example arguments ``(call, per)``."""
    from ldpc_erasure_codes_tpu_torch.sim import DecoderConfig, SimConfig, make_sim_step

    cfg = SimConfig(
        code="n2040_k1530",
        batch=32,
        decoder=DecoderConfig(kind="hybrid", peel_iters=10, emax=64),
    )
    step = make_sim_step("n2040_k1530", cfg, device=device)
    return step, (0, 0.1406)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _summed(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.to(torch.int64).clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _require(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(f"dry run: {what}")


def _bad_frames(vals, cw, erased, mesh) -> torch.Tensor:
    """Frames whose decode differs from the codeword on any lane, or keeps
    an erasure, counted over the data axis: the per-frame flags are OR-ed
    (MAX) over the lane group first."""
    bad = (vals != cw).flatten(1).any(dim=1) | erased.any(dim=1)
    bad = _summed(bad, mesh.get_group(LANE_AXIS), dist.ReduceOp.MAX)
    return _summed(bad.sum(), mesh.get_group(BATCH_AXIS))


def dryrun_multichip(n_devices: int) -> None:
    """The four styles on the first ``n_devices`` ranks (which must be every
    rank of the group); raises AssertionError on a wrong count."""
    from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures
    from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
    from ldpc_erasure_codes_tpu_torch.rs import rs_code, rs_decode_wide, rs_encode
    from ldpc_erasure_codes_tpu_torch.sim import DecoderConfig, SimConfig, make_sim_step

    if dist.get_world_size() != n_devices:
        raise ValueError(f"the dry run spans every rank: {n_devices} devices, "
                         f"{dist.get_world_size()} ranks")
    device = multihost.device()
    code = toy_code(n=48, k=32, seed=3)

    # Style 1: the sharded sim step over the 1-D data mesh.
    mesh1 = make_mesh((n_devices,), (BATCH_AXIS,))
    cfg = SimConfig(code=code.name, batch=2 * n_devices,
                    decoder=DecoderConfig(kind="hybrid", peel_iters=4, emax=8))
    stats = shard_sim_step(make_sim_step(code, cfg, device=device), mesh1)(0, 0.1).to_host()
    _require(stats.frames == cfg.batch * n_devices, stats)

    # Style 2: the (data, lane) mesh, wide binary symbols, word axis split.
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh2 = make_mesh(shape, (BATCH_AXIS, LANE_AXIS))
    arrays = code_arrays(code, device)
    b, w = 4 * shape[0], 4 * shape[1]
    g = _generator(1, device)
    src = torch.randint(-(2**31), 2**31, (b, code.k, w), dtype=torch.int32, generator=g,
                        device=device)
    mask = iid_erasures((b, code.n), 0.1, generator=_generator(2, device), device=device)
    src, mask = shard_batch(src, mesh2, lane_axis_dim=2), shard_batch(mask, mesh2)
    cw = encode_packed(arrays, src)
    vals, erased, _, failed = hybrid_decode(
        arrays, apply_erasures(cw, mask), mask, peel_iters=4, emax=8)
    bad = int(_bad_frames(vals, cw, erased, mesh2))
    n_failed = int(_summed(failed.sum(), mesh2.get_group(BATCH_AXIS)))
    _require(bad == n_failed, (bad, n_failed))

    # Style 3: the GF(256) tier on the same mesh.
    code_nb = toy_code(n=96, k=64, seed=3, gf_order=256)
    arr_nb = code_arrays(code_nb, device)
    wb = 4 * shape[1]
    src8 = torch.randint(0, 256, (b, code_nb.k, wb), dtype=torch.uint8,
                         generator=_generator(3, device), device=device)
    mask = iid_erasures((b, code_nb.n), 0.08, generator=_generator(4, device), device=device)
    src8, mask = shard_batch(src8, mesh2, lane_axis_dim=2), shard_batch(mask, mesh2)
    cw = encode_packed(arr_nb, src8, gf_order=256)
    vals, erased, _, failed = hybrid_decode(
        arr_nb, apply_erasures(cw, mask), mask, gf_order=256, peel_iters=4, emax=8)
    bad = int(_bad_frames(vals, cw, erased, mesh2))
    n_failed = int(_summed(failed.sum(), mesh2.get_group(BATCH_AXIS)))
    _require(bad == n_failed, (bad, n_failed))

    # Style 4: RS(255, 192) wide decode on the same mesh; every frame holds
    # at most n - k erasures, so every frame decodes exactly (MDS).
    code_rs = rs_code(255, 192)
    arr_rs = code_arrays(code_rs, device)
    b_rs = 2 * shape[0]
    rng = np.random.default_rng(7)
    mask_rs = np.zeros((b_rs, code_rs.n), bool)
    for f in range(b_rs):
        mask_rs[f, rng.choice(code_rs.n, 1 + 7 * f % 63, replace=False)] = True
    src_rs = torch.randint(0, 256, (b_rs, code_rs.k, wb), dtype=torch.uint8,
                           generator=_generator(5, device), device=device)
    src_rs = shard_batch(src_rs, mesh2, lane_axis_dim=2)
    mask = shard_batch(torch.from_numpy(mask_rs).to(device), mesh2)
    cw = rs_encode(arr_rs, src_rs)
    vals, erased, failed = rs_decode_wide(arr_rs, apply_erasures(cw, mask), mask)
    data = mesh2.get_group(BATCH_AXIS)
    bad = int(_bad_frames(vals, cw, torch.zeros_like(erased), mesh2))
    n_failed = int(_summed(failed.sum(), data))
    resid = int(_summed(erased.sum(), data))
    _require(bad == 0 and n_failed == 0 and resid == 0, (bad, n_failed, resid))
