"""Timing and throughput helpers.

Counterpart of ``ldpc_erasure_codes_tpu/utils/profiling.py`` (:1-91):
``Timing`` with JAX's properties, ``time_fn`` with JAX's contract, and
``trace`` over ``torch.profiler`` where JAX's runs ``jax.profiler``.

The reference instruments with MATLAB tic/toc accumulators
(LDPCErasureCodes_MessagePassingAlgSim.m:210-219) and OpenCL event profiling
with the throughput formula S·frames·k/T
(OpenCL/host/src/main.cpp:515,652-658). Equivalents here: wall-clock timing
of device callables with the warm-up (kernel builds) excluded, the same
information-bit throughput formula, and a Chrome trace of the host and
device activity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Timing:
    """One measured kernel: wall seconds over ``reps`` calls (warm-up
    excluded), plus derived rates."""

    name: str
    reps: int
    seconds: float
    items: int = 0  # e.g. frames processed across all reps

    @property
    def per_call(self) -> float:
        return self.seconds / max(self.reps, 1)

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def info_gbps(self, k: int, symbol_bits: int) -> float:
        """S·frames·k/T (main.cpp:652-658)."""
        return self.items_per_sec * k * symbol_bits / 1e9


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(
    fn: Callable[..., Any],
    *args,
    reps: int = 10,
    warmup: int = 1,
    name: str | None = None,
    items_per_call: int = 0,
) -> Timing:
    """Time a device callable: warm-up (kernel builds) first, then ``reps``
    calls timed as one span with a single ``torch.cuda.synchronize`` at the
    end (throughput convention: calls queue on the device like the
    reference's streamed frames). On the CPU the calls are synchronous.

    Caveat (measured in the JAX package): make ``fn`` *consume* its
    computation (e.g. return a reduction): repeated identical calls whose
    big outputs go unused were observed to report physically impossible
    rates (the runtime elides work), e.g. a phantom 343 Tbps for an encoder
    whose honest, consumed measurement is 190 Gbps."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _synchronize()
    dt = time.perf_counter() - t0
    return Timing(
        name=name or getattr(fn, "__name__", "fn"),
        reps=reps,
        seconds=dt,
        items=items_per_call * reps,
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context: the host and (with a card) device
    activity of the block, written on exit as a Chrome trace
    ``<log_dir>/trace_<pid>_<ns>.json`` (view it in Perfetto or
    chrome://tracing).

    Usage::

        with profiling.trace("/tmp/torch-trace"):
            step(gen, cw)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
