"""Timing and throughput helpers, and the port's own spans and counters.

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

Inside the decoders, :func:`span` marks a stage and :func:`count` adds to a
counter. Both do nothing (one flag check) unless tracing is on: while a
``torch.profiler`` session records, or inside :func:`recording`. Then each
span enters the profiler's host timeline as a host op (not a user
annotation, so a caller's ``record_function`` ranges keep the kernels
launched beneath it), and adds its calls, host seconds and, on a CUDA
device, the stream milliseconds between a pair of CUDA events to a record
keyed by its path (``hybrid.decode/hybrid.escalate/ge.elim``). The events
are read only by :func:`snapshot`; no span syncs with the host.
:func:`sync_sites` names the line of the package behind each host sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback
import warnings
from typing import Any, Callable

import torch
import torch.autograd.profiler as _autograd_profiler


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


# What torch warns for each sync in "warn" mode. Its one-time notice on the
# first switch to that mode ("... does not yet detect all synchronizing
# operations") is not a sync, and is not counted.
SYNC_WARNING = "called a synchronizing CUDA operation"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_site(stack: list[traceback.FrameSummary], filename: str, lineno: int) -> str:
    """``file:line`` (from the package's parent directory) of the innermost
    frame of ``stack`` that lies in this package; the warning's own
    ``filename:lineno`` where none does."""
    for f in reversed(stack):
        path = os.path.abspath(f.filename)
        if path.startswith(_PKG + os.sep):
            return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{f.lineno}"
    return f"{filename}:{lineno}"


@contextlib.contextmanager
def sync_sites():
    """While open, collect the :func:`port_site` of each host sync that
    ``torch.cuda.set_sync_debug_mode("warn")`` warns of (:data:`SYNC_WARNING`).
    Such a warning names a file of torch's C++ sources, so the site is read
    from the Python stack in a ``showwarning`` hook."""
    sites: list[str] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            sites.append(port_site(traceback.extract_stack()[:-1], filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        yield sites


class _Record:
    """What the spans and counters gathered since the last :func:`reset`,
    from the one thread that runs the decoders.

    ``stack`` holds the open spans' (path, stream); ``spans`` maps a path to
    [calls, host ns, stream ms, stream ms seen]; ``pending`` holds (path,
    begin, end) CUDA events not yet read, ``free`` read events for reuse;
    ``device`` the counters held on a card."""

    def __init__(self):
        self.calls = 0
        self.stack: list[tuple] = []
        self.spans: dict[str, list] = {}
        self.counters: dict[str, int] = {}
        self.device: dict[str, torch.Tensor] = {}
        self.pending: list[tuple] = []
        self.free: list = []

    def event(self):
        return self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)

    def add(self, path: str, host_ns: int, begin, end) -> None:
        s = self.spans.get(path)
        if s is None:
            s = self.spans[path] = [0, 0, 0.0, False]
        s[0] += 1
        s[1] += host_ns
        if begin is not None:
            self.pending.append((path, begin, end))

    def resolve(self) -> None:
        """Read every pending pair of events, waiting for each to complete."""
        for path, begin, end in self.pending:
            end.synchronize()
            s = self.spans.get(path)
            if s is not None:
                s[2] += begin.elapsed_time(end)
                s[3] = True
            self.free += (begin, end)
        self.pending = []


_record = _Record()
_recording = 0


def enabled() -> bool:
    """Whether spans and counters record: a ``torch.profiler`` session is
    recording, or a :func:`recording` block is open."""
    return _recording > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Off:
    """The span of a program that is not tracing: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span of a tracing program (see :func:`span`)."""

    __slots__ = ("name", "device", "args", "path", "stream", "fast", "begin", "t0")

    def __init__(self, name: str, device, args: dict):
        self.name, self.device, self.args = name, device, args

    def __enter__(self):
        st = _record.stack
        if st:
            parent, self.stream = st[-1]
            self.path = f"{parent}/{self.name}"
            args = self.args
        else:  # the top span of a call: give the call its number, find its stream
            self.path = self.name
            dev = None if self.device is None else torch.device(self.device)
            # Looked up once a call: ``current_stream`` costs more than a record.
            self.stream = torch.cuda.current_stream(dev) if dev and dev.type == "cuda" else None
            _record.calls += 1
            args = {"call": _record.calls, **self.args}
        st.append((self.path, self.stream))
        self.fast = None
        if _autograd_profiler._is_profiler_enabled:
            fast = torch._C._profiler._RecordFunctionFast
            self.fast = fast(self.name, keyword_values=args) if args else fast(self.name)
            self.fast.__enter__()
        self.begin = None
        if self.stream is not None:
            self.begin = _record.event()
            self.begin.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        end = None
        if self.stream is not None:
            end = _record.event()
            end.record(self.stream)
        if self.fast is not None:
            self.fast.__exit__(*exc)
        _record.stack.pop()
        _record.add(self.path, host_ns, self.begin, end)
        return False


def span(name: str, *, device: torch.device | str | None = None, **args):
    """A stage of a call, as a context manager: a no-op unless :func:`enabled`.

    A span opened inside another is recorded under ``<parent path>/<name>``;
    a span opened outside any is a call's top span, numbered (its profiler
    event carries ``call``, with ``args``). ``device``, on a top span, is
    the device the call runs on: on a CUDA device the span and every span
    beneath it also time the current stream between two CUDA events. Names
    must not start with ``cu``: trace readers take such host events for
    runtime calls."""
    return _Span(name, device, args) if enabled() else _OFF


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while :func:`enabled`: a host int,
    or a 0-d device tensor, summed on its device and read by
    :func:`snapshot` (one small kernel, no sync)."""
    if not enabled():
        return
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        acc = _record.device.get(name)
        if acc is None:
            acc = _record.device[name] = torch.zeros((), dtype=torch.int64, device=value.device)
        acc.add_(value)
    else:
        _record.counters[name] = _record.counters.get(name, 0) + int(value)


def snapshot() -> dict:
    """The record: ``{"calls": top-level calls, "spans": {path: {"calls",
    "host_s", "stream_ms"}}, "counters": {name: int}}``, ``stream_ms`` None
    for spans never timed on a card. Syncs the card where it has events or
    counters to read."""
    _record.resolve()
    counters = dict(_record.counters)
    for name, acc in _record.device.items():
        counters[name] = counters.get(name, 0) + int(acc)
    spans = {path: {"calls": c, "host_s": ns / 1e9, "stream_ms": ms if seen else None}
             for path, (c, ns, ms, seen) in _record.spans.items()}
    return {"calls": _record.calls, "spans": spans, "counters": counters}


def reset() -> None:
    """Clear the record (spans open now are recorded when they close)."""
    _record.resolve()
    _record.calls = 0
    _record.spans.clear()
    _record.counters.clear()
    _record.device.clear()
