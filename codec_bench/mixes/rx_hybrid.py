"""Receive with the hybrid decoder and escalation:
``ops.hybrid_decode_escalated`` (the peel kernel, then the compacted
Gauss-Jordan of ``ops/compact.py`` and ``ops/ge.py``, then a second GE for the
frames its buckets could not hold). Maximum-likelihood: a frame fails only
where the erased columns of H are dependent over the code's field. A GF(256)
code (``"gf_order": 256``) decodes the received words' bytes."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from codec_bench import port

LAYER = "hybrid"
POOL = "rx"
RECOVERY = "ml_rank"
DELIVERS = "all"


def setup(config, device):
    settings = config["decoder"]["hybrid"]
    nb = port.gf256(config)
    return SimpleNamespace(arrays=port.code_arrays(config, device), nb=nb,
                           settings=dict(settings, gf_order=256) if nb else settings)


def call(state, received, mask):
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode_escalated

    if state.nb:
        received = received.view(torch.uint8)
    values, erased, _, failed, _ = hybrid_decode_escalated(state.arrays, received, mask,
                                                           **state.settings)
    return port.Out(values.view(torch.int32) if state.nb else values, erased, failed)


def failed(state, out):
    return out.failed
