"""LDPC code objects, read from the shipped ``.npz`` data."""

from ldpc_erasure_codes_tpu_torch.codes.io import (
    DATA_DIR,
    LDPCCode,
    from_vlist,
    get_code,
    list_codes,
)

__all__ = ["DATA_DIR", "LDPCCode", "from_vlist", "get_code", "list_codes"]
