"""Monte-Carlo FER simulation: config, the step, the driver, statistics."""

from ldpc_erasure_codes_tpu_torch.sim.config import ChannelConfig, DecoderConfig, SimConfig
from ldpc_erasure_codes_tpu_torch.sim.driver import (
    FERPoint,
    format_report,
    make_sim_step,
    run_fer_point,
    run_fer_sweep,
    symbol_bits,
)
from ldpc_erasure_codes_tpu_torch.sim.stats import Accumulator, SimStats, batch_stats

__all__ = [
    "Accumulator",
    "ChannelConfig",
    "DecoderConfig",
    "FERPoint",
    "SimConfig",
    "SimStats",
    "batch_stats",
    "format_report",
    "make_sim_step",
    "run_fer_point",
    "run_fer_sweep",
    "symbol_bits",
]
