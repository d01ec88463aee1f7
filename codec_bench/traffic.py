"""The one traffic generator: it reads a mix's data file and draws its batches.

A traffic file, ``traffic/<name>.json``, holds

* ``mix``: the module of ``mixes/`` whose entry the cell drives;
* ``batch``: frames per call;
* ``pool_batches``: batches built before the window, which the window cycles
  through (the receive or send buffers a deployment holds);
* ``sample_frames``: frames whose outputs each call hands to the check,
  a different slice of the pool batch at each visit (it divides ``batch``);
* ``loss``: ``{"model": "iid", "per": p}``, each symbol lost with
  probability p, or ``{"model": "gilbert_elliott", "alpha": .., "beta": ..,
  "transition": .., "bias": ..}``, the two-state bursty channel of
  ``ErasureCodes_NonBinaryLDPCSim.m:131-139`` along each frame; absent for
  mixes that send. With a ``"seed"`` of its own the losses are the same in
  every run, and the run's seed only orders the pool batches (and draws the
  source): for a decoder whose work depends on rare heavy patterns, so that
  every run does the same work.

A simulation mix (``mixes/sim_peel.py``) draws nothing here: the program's
simulation step draws its own batches from the run's seed, and the reference
draws them again (:mod:`codec_bench.reference.sim`). Its file holds ``mix``,
``batch``, ``steps_per_call`` (batches a call of the step runs and sums),
``pool_calls`` (the call indices the window cycles through), ``loss`` (i.i.d.
only), ``pattern_only`` and the ``decoder`` (``kind``, ``max_iters``,
``early_stop_k``).

Every draw comes from its own generator on the card, seeded from
(``--seed``, pool batch, stream), so a seed gives the same inputs whatever
the mix draws first, and the reference draws them again after the window.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

STREAMS = {"source": 0, "loss": 1, "sample": 2, "order": 3}


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    if "sample_frames" in t and t["batch"] % t["sample_frames"]:
        raise ValueError(f"traffic {name}: sample_frames must divide batch")
    return t


def stream_seed(seed: int, pool_batch: int, stream: str) -> int:
    """A 63-bit seed for one stream of one pool batch."""
    state = np.random.SeedSequence([seed % 2**64, pool_batch, STREAMS[stream]]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, pool_batch: int, stream: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, pool_batch, stream))
    return g


def source(seed: int, pool_batch: int, shape: tuple[int, int, int], device) -> torch.Tensor:
    """(B, k, W) uniform int32 source words."""
    g = generator(seed, pool_batch, "source", device)
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=g, device=device)


def loss(spec: dict, seed: int, pool_batch: int, pool_batches: int, shape: tuple[int, int],
         device) -> torch.Tensor:
    """(B, n) bool, True where a symbol was lost."""
    if "seed" in spec:
        order = np.random.default_rng(stream_seed(seed, 0, "order")).permutation(pool_batches)
        seed, pool_batch = spec["seed"], int(order[pool_batch])
    g = generator(seed, pool_batch, "loss", device)
    if spec["model"] == "iid":
        return torch.rand(shape, generator=g, device=device) <= spec["per"]
    if spec["model"] == "gilbert_elliott":
        return gilbert_elliott(spec, torch.rand((shape[1], shape[0], 2), generator=g, device=device))
    raise ValueError(f"unknown loss model {spec['model']!r}")


def gilbert_elliott(spec: dict, u: torch.Tensor) -> torch.Tensor:
    """The two-state chain along each frame from uniforms u (n, B, 2), every
    frame starting Good: symbol i is lost when ``u[i, :, 0] <=`` its state's
    loss rate (``alpha`` Good, ``beta`` Bad), then the state moves on
    ``u[i, :, 1]``: Good to Bad with ``transition / bias``, Bad to Good with
    ``transition``."""
    n, b, _ = u.shape
    bad = torch.zeros((b,), dtype=torch.bool, device=u.device)
    mask = torch.empty((n, b), dtype=torch.bool, device=u.device)
    to_bad, to_good = spec["transition"] / spec["bias"], spec["transition"]
    for i in range(n):
        mask[i] = u[i, :, 0] <= torch.where(bad, spec["beta"], spec["alpha"])
        bad ^= u[i, :, 1] <= torch.where(bad, to_good, to_bad)
    return mask.t().contiguous()


def sample_slots(seed: int, pool_batch: int, batch: int, per_visit: int) -> np.ndarray:
    """(batch // per_visit, per_visit) frame indices: visit v of a pool batch
    hands row ``v % rows`` to the check, so the visits cover every frame."""
    rng = np.random.default_rng(stream_seed(seed, pool_batch, "sample"))
    return rng.permutation(batch).reshape(-1, per_visit)
