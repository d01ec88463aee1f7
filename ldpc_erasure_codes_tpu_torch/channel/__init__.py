"""Erasure channels."""

from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures

__all__ = ["apply_erasures", "iid_erasures"]
