"""Receive with the hybrid decoder and escalation:
``ops.hybrid_decode_escalated`` (the peel kernel, then the compacted binary
Gauss-Jordan of ``ops/compact.py`` and ``ops/ge.py``, then a second GE for the
frames its buckets could not hold). Maximum-likelihood: a frame fails only
where the erased columns of H are dependent."""

from __future__ import annotations

from types import SimpleNamespace

from codec_bench import port

LAYER = "hybrid"
POOL = "rx"
RECOVERY = "ml_rank"
DELIVERS = "all"


def setup(config, device):
    return SimpleNamespace(arrays=port.code_arrays(config, device),
                           settings=config["decoder"]["hybrid"])


def call(state, received, mask):
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode_escalated

    values, erased, _, failed, _ = hybrid_decode_escalated(state.arrays, received, mask,
                                                           **state.settings)
    return port.Out(values, erased, failed)


def failed(state, out):
    return out.failed
