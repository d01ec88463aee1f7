"""Configuration dataclasses of the FER simulation.

The port's own copy of ``ldpc_erasure_codes_tpu/sim/config.py`` (pure
dataclasses, the same fields, defaults and validation). The reference
configures by editing MATLAB lines and a small CLI on the OpenCL host
(OpenCL/host/src/main.cpp:157-170); here the whole space is typed: code
registry key, channel, decoder, batch and symbol geometry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Erasure-channel operating point.

    kind:
      * ``iid`` — i.i.d. with real-valued ``per``
        (Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:183-188);
      * ``per64`` — i.i.d. with PER = per_numerator/64, the FPGA's on-device
        parameterisation (OpenCL/device/ldpc_erasure_decoder_top.cl:102-110);
      * ``gilbert_elliott`` — 2-state bursty channel
        (Matlab/Bursty_Error_Channel_Model_Generator.m:12-47).
    """

    kind: str = "iid"
    per: float = 0.1
    per_numerator: int = 9
    ge_alpha: float = 0.01
    ge_beta: float = 0.5
    ge_transition: float = 0.1
    ge_bias: float = 10.0
    carry_state: bool = True  # start each frame's chain in the steady state

    def __post_init__(self):
        if self.kind not in ("iid", "per64", "gilbert_elliott"):
            raise ValueError(f"unknown channel kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder selection and iteration budget.

    kind: ``peel`` (MPA only), ``hybrid`` (MPA then Gauss-Jordan on the
    residual), or ``ml`` (Gauss-Jordan from scratch, no peeling).
    impl: the peel, as the JAX package's: ``"vmem"`` runs the sequential
    peel kernel on wide symbols, in the "unrolled" schedule when
    ``schedule`` is "unrolled" and in "seq" for every other schedule, as
    the JAX driver does; every other value (and "vmem" on scalar symbols,
    read as "gather") is the ``impl`` of ``peel_decode_jacobi``:
    ``"gather"`` (default) the Jacobi sweep, ``"matmul"`` its three
    products with H (binary scalar symbols only), ``"worklist"`` at most
    128 degree-1 checks per frame and sweep. The hybrid reads it as
    ``hybrid_decode`` does. An ``impl`` JAX refuses raises when the step
    decodes.
    """

    kind: str = "hybrid"
    max_iters: int = 50  # peel-only cap (My_LDPC_Erasure_Decoder.m:10)
    peel_iters: int = 10  # hybrid peel budget (My_LDPC_HybridML_Erasure_Decoder.m:9)
    emax: int = 128  # residual-GE column bucket
    impl: str = "gather"  # "gather" | "matmul" | "worklist" | "vmem" peeling step
    # Peel kernel schedule for impl="vmem": "unrolled" runs that schedule,
    # any other value "seq" (the JAX driver's mapping; both are one function).
    schedule: str = "seq"
    early_stop_k: bool = False  # FPGA first-k-known early exit
    ge_subbatch: int = 0  # >0: compact residual frames into this bucket for GE
    # Block-error scope: False counts residual erasures among the first k
    # info symbols (the FPGA's accounting, decoder_perf_tests.cl:215-228);
    # True counts any residual symbol, the MATLAB sims' whole-codeword
    # comparison (LDPCErasureCodes_MessagePassingAlgSim.m:229-236).
    count_all_symbols: bool = False

    def __post_init__(self):
        if self.kind not in ("peel", "hybrid", "ml"):
            raise ValueError(f"unknown decoder kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One simulation campaign.

    symbol_words: 0 → scalar symbols (one uint8 per code symbol, the MATLAB
    sims' geometry); W > 0 → packed wide symbols of W words (int32 words for
    binary = 32W bits per symbol; W uint8 bytes for GF(256)). The FPGA's
    8192-bit packet is symbol_words=256 binary.
    track_values: False takes the pattern-only fast path: FER depends only
    on the erasure patterns (peeling progress and GE rank are
    value-independent), so the encoder and all symbol values are skipped.
    steps_per_call: batches per call of the step; their statistics are
    summed on the device, with one host read per call.
    tiled_pipeline: the JAX package's tile-major encode -> decode handoff;
    the port keeps the flat layout, so here it means the flat handoff with
    the masking fused into the peel kernel (no separate zeroing pass). The
    statistics are the same. Requires packed symbols, impl="vmem" and kind
    peel/hybrid, as in JAX.
    """

    code: str = "n2000_k1000"
    gf_order: int = 2
    batch: int = 256
    symbol_words: int = 0
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    seed: int = 0
    track_values: bool = True
    steps_per_call: int = 1
    tiled_pipeline: bool = False

    def __post_init__(self):
        if self.gf_order not in (2, 256):
            raise ValueError("gf_order must be 2 or 256")
        if self.tiled_pipeline:
            if self.symbol_words <= 0:
                raise ValueError("tiled_pipeline requires packed symbols")
            if self.decoder.impl != "vmem" or self.decoder.kind == "ml":
                raise ValueError(
                    "tiled_pipeline requires decoder impl='vmem' and kind peel/hybrid"
                )
