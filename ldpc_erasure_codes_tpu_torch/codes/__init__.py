"""LDPC code objects, read from the shipped ``.npz`` data, and their
host-side construction (``generate``) and generator-matrix tools
(``gmatrix``)."""

from ldpc_erasure_codes_tpu_torch.codes.io import (
    DATA_DIR,
    LDPCCode,
    from_h_dense,
    from_vlist,
    get_code,
    list_codes,
    load_code,
    load_mat_code,
    parse_vlist_header,
    save_code,
)
from ldpc_erasure_codes_tpu_torch.codes.generate import (
    CycleCensus,
    cycle_census,
    expand_profile,
    gen_column_wise,
    gen_row_wise,
    grid_code,
    weight_histograms,
)
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code

__all__ = [
    "DATA_DIR",
    "CycleCensus",
    "LDPCCode",
    "cycle_census",
    "expand_profile",
    "from_h_dense",
    "from_vlist",
    "gen_column_wise",
    "gen_row_wise",
    "get_code",
    "grid_code",
    "list_codes",
    "load_code",
    "load_mat_code",
    "parse_vlist_header",
    "save_code",
    "toy_code",
    "weight_histograms",
]
