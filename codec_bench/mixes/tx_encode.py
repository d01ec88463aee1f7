"""Send: the systematic encoder (``ops.encode_packed``, ``csrc/encode.cu``;
``rs.rs_encode`` for RS codes) on batches of source symbols."""

from __future__ import annotations

from types import SimpleNamespace

from codec_bench import port

LAYER = "encode"
POOL = "tx"


def setup(config, device):
    return SimpleNamespace(config=config, arrays=port.code_arrays(config, device))


def call(state, source):
    return port.Out(port.encode(state.config, state.arrays, source), None, None)


def failed(state, out):
    return None
