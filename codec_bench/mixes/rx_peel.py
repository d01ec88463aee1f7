"""Receive with the peeling decoder alone: ``ops.peel_decode`` (the seq
schedule kernel and the slab value kernel of ``csrc/peel.cu``), stopping once
a frame's first k symbols are known. A frame fails when one of them is left."""

from __future__ import annotations

from types import SimpleNamespace

from codec_bench import port

LAYER = "peel"
POOL = "rx"
RECOVERY = "peel_closure"
DELIVERS = "first_k"


def setup(config, device):
    return SimpleNamespace(arrays=port.code_arrays(config, device), k=config["code"]["k"],
                           settings=config["decoder"]["peel"])


def call(state, received, mask):
    from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode

    values, erased, _ = peel_decode(state.arrays, received, mask, **state.settings)
    return port.Out(values, erased, None)


def failed(state, out):
    return out.erased[:, : state.k].any(dim=1)
