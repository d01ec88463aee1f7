"""Rank-mesh parallelism for the codeword batch.

Counterpart of ``ldpc_erasure_codes_tpu/parallel/``. The reference has no
distributed layer (a single FPGA; SURVEY §2.7); its parallelism is
bit-plane lanes and frame streaming. Here the codeword batch is the scaling
axis: decode is embarrassingly parallel per codeword, so one process per
card takes a shard of the batch (and, on a 2-D mesh, of the packed word
axis), and collectives only sum statistics: the counterpart of the FPGA's
``ERROR_STAT`` channel (OpenCL/device/ldpc_erasure_decoder_top.cl:55,
124-158).
"""

from ldpc_erasure_codes_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    LANE_AXIS,
    default_mesh,
    make_mesh,
    shard_batch,
    shard_sim_step,
)
from ldpc_erasure_codes_tpu_torch.parallel import multihost
from ldpc_erasure_codes_tpu_torch.parallel.scaling import ScalePoint, measure_scaling

__all__ = [
    "BATCH_AXIS",
    "LANE_AXIS",
    "default_mesh",
    "make_mesh",
    "ScalePoint",
    "measure_scaling",
    "multihost",
    "shard_batch",
    "shard_sim_step",
]
