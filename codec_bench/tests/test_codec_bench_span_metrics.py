"""The readers of the program's spans and counters, on synthetic records:
None where the record holds no call of the reader's entry or the run is of
another layer, and the value per call where it does."""

from __future__ import annotations

import pytest
from conftest import BENCH

from codec_bench import harness
from ldpc_erasure_codes_tpu_torch.utils import profiling

READERS = harness.metric_readers(BENCH)


def _span(calls, host_s, stream_ms):
    return {"calls": calls, "host_s": host_s, "stream_ms": stream_ms}


HYBRID = {
    "calls": 4,
    "spans": {
        "hybrid.decode": _span(4, 0.060, 52.0),
        "hybrid.decode/hybrid.peel": _span(4, 0.004, 10.0),
        "hybrid.decode/hybrid.peel/peel.decode": _span(4, 0.003, 9.5),
        "hybrid.decode/hybrid.sync.residual": _span(4, 0.002, 0.2),
        "hybrid.decode/hybrid.ge.compact": _span(4, 0.010, 20.0),
        "hybrid.decode/hybrid.ge.compact/ge.elim": _span(4, 0.001, 6.0),
        "hybrid.decode/hybrid.sync.failed": _span(4, 0.001, 0.1),
        "hybrid.decode/hybrid.escalate": _span(2, 0.020, 12.0),
        "hybrid.decode/hybrid.escalate/hybrid.sync.candidates": _span(2, 0.003, 0.3),
        "hybrid.decode/hybrid.escalate/hybrid.sync.emax": _span(2, 0.002, 0.1),
        "hybrid.decode/hybrid.escalate/ge.elim": _span(2, 0.001, 5.0),
    },
    "counters": {"hybrid.residual_frames": 2300, "hybrid.escalated_frames": 480},
}
RS = {
    "calls": 2,
    "spans": {
        "rs.decode": _span(2, 0.002, 11.0),
        "rs.decode/ge.cube": _span(2, 0.0005, 0.4),
        "rs.decode/ge.elim": _span(2, 0.0002, 0.6),
        "rs.decode/ge.transforms": _span(2, 0.0001, 0.1),
        "rs.decode/ge.syndrome": _span(2, 0.0002, 8.0),
        "rs.decode/ge.apply": _span(2, 0.0002, 1.8),
    },
    "counters": {},
}
EMPTY = {"calls": 0, "spans": {}, "counters": {}}
EXPECTED = {
    "hybrid.peel_ms": ("hybrid", HYBRID, 10.0 / 4),
    "hybrid.ge_ms": ("hybrid", HYBRID, 20.0 / 4),
    "hybrid.escalate_ms": ("hybrid", HYBRID, 12.0 / 4),
    "hybrid.escalated_frames": ("hybrid", HYBRID, 480 / 4),
    "hybrid.sync_wait_ms": ("hybrid", HYBRID, 1e3 * (0.002 + 0.001 + 0.003 + 0.002) / 4),
    "rs.syndrome_ms": ("rs", RS, 8.0 / 2),
    "rs.glue_ms": ("rs", RS, (11.0 - 0.6 - 8.0 - 1.8) / 2),
}


def _view(layer: str):
    return harness.RunView(layer, 8, 255, 192, 4, "NVIDIA H100 80GB HBM3", None, None)


def test_every_span_reader_is_in_the_benchmark():
    assert set(EXPECTED) <= set(READERS)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_a_record(monkeypatch, metric):
    layer, rec, want = EXPECTED[metric]
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    assert READERS[metric].read(_view(layer)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_is_silent_without_its_calls(monkeypatch, metric):
    layer, rec, _ = EXPECTED[metric]
    other = "rs" if layer == "hybrid" else "hybrid"
    monkeypatch.setattr(profiling, "snapshot", lambda: EMPTY)
    assert READERS[metric].read(_view(layer)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    assert READERS[metric].read(_view(other)) is None
    assert READERS[metric].read(_view("peel")) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_is_silent_on_a_program_without_spans(monkeypatch, metric):
    """A program whose profiling module keeps no record (before spans)."""
    layer, _, _ = EXPECTED[metric]
    monkeypatch.delattr(profiling, "snapshot")
    assert READERS[metric].read(_view(layer)) is None


def test_stage_without_calls_reads_zero(monkeypatch):
    """A run in which no call escalated: escalation's metrics read 0."""
    rec = {**HYBRID, "spans": {p: s for p, s in HYBRID["spans"].items() if "escalate" not in p},
           "counters": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    assert READERS["hybrid.escalate_ms"].read(_view("hybrid")) == 0.0
    assert READERS["hybrid.escalated_frames"].read(_view("hybrid")) == 0.0


def test_stream_time_not_measured_on_a_card_reads_none(monkeypatch):
    """Spans recorded on the CPU carry no stream time; the readers of stream
    time then report nothing."""
    rec = {**RS, "spans": {p: {**s, "stream_ms": None} for p, s in RS["spans"].items()}}
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    assert READERS["rs.syndrome_ms"].read(_view("rs")) is None
    assert READERS["rs.glue_ms"].read(_view("rs")) is None
