"""Receive with the Reed-Solomon packet decoder: ``rs.rs_decode_wide`` (the
three GF(256) kernels of ``ops/ge.py::ge_solve_wide_nb``: ``gf256_eliminate``,
``gf_matvec_wide``, ``gf_apply_scatter``). A frame fails when it lost more
than n - k symbols."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from codec_bench import port

LAYER = "rs"
POOL = "rx"
RECOVERY = "mds"
DELIVERS = "all"


def setup(config, device):
    return SimpleNamespace(arrays=port.code_arrays(config, device))


def call(state, received, mask):
    from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode_wide

    values, erased, failed = rs_decode_wide(state.arrays, received.view(torch.uint8), mask)
    return port.Out(values.view(torch.int32), erased, failed)


def failed(state, out):
    return out.failed
