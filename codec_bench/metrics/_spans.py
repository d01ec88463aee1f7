"""What the readers of the program's spans share: the record that
``ldpc_erasure_codes_tpu_torch.utils.profiling`` keeps while a profiler
records (the traced window and the two batches of the trace slice after it),
and the calls of one entry's top span in it."""

from __future__ import annotations


def record(profiling, run, layer: str, top: str):
    """(snapshot, calls of ``top``), or None where the run is not of
    ``layer``, or the program keeps no record (a program without spans) or
    no call of ``top`` in it."""
    snapshot = getattr(profiling, "snapshot", None)
    if run.layer != layer or snapshot is None:
        return None
    rec = snapshot()
    calls = rec["spans"].get(top, {}).get("calls", 0)
    return (rec, calls) if calls else None


def stream_ms(rec: dict, paths) -> float | None:
    """Stream milliseconds summed over ``paths`` (those absent count 0), or
    None where one of them was not timed on a card."""
    total = 0.0
    for path in paths:
        s = rec["spans"].get(path)
        if s is not None:
            if s["stream_ms"] is None:
                return None
            total += s["stream_ms"]
    return total


def children(rec: dict, parent: str, prefix: str) -> list[str]:
    """The paths directly under ``parent`` whose span name starts with ``prefix``."""
    head = parent + "/"
    names = (p[len(head):] for p in rec["spans"] if p.startswith(head))
    return [head + name for name in names if "/" not in name and name.startswith(prefix)]
