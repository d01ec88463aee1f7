"""Erasure channels."""

from ldpc_erasure_codes_tpu_torch.channel.erasure import (
    GilbertElliottParams,
    apply_erasures,
    gilbert_elliott_chain,
    gilbert_elliott_erasures,
    gilbert_elliott_steady_state,
    iid_erasures,
    iid_erasures_per64,
)

__all__ = [
    "GilbertElliottParams",
    "apply_erasures",
    "gilbert_elliott_chain",
    "gilbert_elliott_erasures",
    "gilbert_elliott_steady_state",
    "iid_erasures",
    "iid_erasures_per64",
]
