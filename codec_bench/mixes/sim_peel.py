"""The FER simulation's step, pattern-only peel: ``sim.make_sim_step``, the
step that ``cli sim`` and ``run_fer_point`` call. A call is one call of the
step on a call index: ``steps_per_call`` batches, each drawn by the step from
its own generator (the run's seed, the call, the batch), peeled as masks
(``ops/peel_jacobi.py::peel_decode_mask``) and folded into ``SimStats``,
summed on the card. What reaches the host after a call is its counters, in
one tensor."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from codec_bench.reference import sim as ref_sim

LAYER = "sim"
POOL = "sim"


def setup(config, device, traffic, seed):
    from ldpc_erasure_codes_tpu_torch.sim import ChannelConfig, DecoderConfig, SimConfig

    d = traffic["decoder"]
    cfg = SimConfig(
        code=config["code"]["port_name"],
        batch=traffic["batch"],
        symbol_words=config["symbol_bytes"] // 4,
        channel=ChannelConfig(kind="iid", per=traffic["loss"]["per"]),
        decoder=DecoderConfig(kind=d["kind"], max_iters=d["max_iters"],
                              early_stop_k=d["early_stop_k"]),
        seed=seed,
        track_values=not traffic["pattern_only"],
        steps_per_call=traffic["steps_per_call"],
    )
    return variant(SimpleNamespace(cfg=cfg, device=device, pool_calls=traffic["pool_calls"]))


def variant(state, *, max_iters: int | None = None, steps_per_call: int | None = None):
    """``state`` with the step rebuilt for a changed decoder budget or batch
    count (the control and the faults); as it is without changes."""
    from ldpc_erasure_codes_tpu_torch.sim import SimStats, make_sim_step

    if tuple(SimStats._fields) != ref_sim.FIELDS:
        raise ValueError(f"SimStats fields {SimStats._fields}, the check reads {ref_sim.FIELDS}")
    cfg = state.cfg
    if max_iters is not None:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_iters=max_iters))
    if steps_per_call is not None:
        cfg = dataclasses.replace(cfg, steps_per_call=steps_per_call)
    return SimpleNamespace(cfg=cfg, device=state.device, pool_calls=state.pool_calls,
                           step=make_sim_step(cfg.code, cfg, device=state.device))


def call(state, call_index):
    return state.step(call_index, state.cfg.channel.per)


def failed(state, out):
    """The call's counters, flattened in ``SimStats``' order."""
    return torch.cat([t.reshape(-1).to(torch.int64) for t in out])
