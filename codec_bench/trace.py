"""What the traced run reads from ``torch.profiler``'s events.

The harness opens a range per call (named by the mix's ``LAYER``) and around
its own work (``codec.sync``, ``codec.check``), all inside ``codec.window``.
Each device activity (kernel, copy, fill) is tied by its correlation id to
the runtime call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
...), and so to the range the host was in when it launched it. From that:

* ``busy_s``: the union of device activity inside the window;
* ``range_device_s`` / ``range_calls``: each range's device seconds and its
  number of openings;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: device idle time inside the window, summed by what the host
  was doing when the device went idle (the range, and the innermost host
  operation), the ten largest.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "codec.window"
NAME_CHARS = 96


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    range_device_s: dict[str, float]
    range_calls: dict[str, int]
    device_ops: list[list]
    idle_gaps: list[list]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def _innermost(ops: list[tuple[int, int, str]], starts: list[int], t: int) -> str:
    """Name of the latest-starting host op that still runs at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "-"


def summarize(events) -> Summary:
    """Reduce ``prof.profiler.kineto_results.events()`` of a traced window."""
    from torch.autograd import DeviceType

    ranges, ops, device, launch = [], [], [], {}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
            if e.is_user_annotation():
                ranges.append((start, end, name))
            elif name.startswith("cu"):
                launch[e.correlation_id()] = start
            else:
                ops.append((start, end, name))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id()))
    window = [r for r in ranges if r[2] == WINDOW]
    if len(window) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(window)}")
    w0, w1, _ = window[0]
    inner = sorted(r for r in ranges if r[2] != WINDOW and w0 <= r[0] and r[1] <= w1)
    inner_starts = [r[0] for r in inner]
    ops.sort()
    op_starts = [o[0] for o in ops]

    def host_range(t: int) -> str:
        i = bisect.bisect_right(inner_starts, t) - 1
        return inner[i][2] if i >= 0 and inner[i][1] >= t else "codec.loop"

    range_s: dict[str, float] = collections.defaultdict(float)
    op_s: dict[str, float] = collections.defaultdict(float)
    spans = []
    for start, end, name, corr in device:
        a, b = max(start, w0), min(end, w1)
        if b <= a:
            continue
        spans.append((a, b))
        op_s[_short(name)] += (b - a) / 1e9
        range_s[host_range(launch.get(corr, start))] += (b - a) / 1e9
    spans.sort()
    busy, gaps, cursor = 0, collections.defaultdict(float), w0
    for a, b in spans:
        if a > cursor:
            gaps[f"{host_range(cursor)}/{_short(_innermost(ops, op_starts, cursor))}"] += (a - cursor) / 1e9
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps[f"{host_range(cursor)}/{_short(_innermost(ops, op_starts, cursor))}"] += (w1 - cursor) / 1e9
    calls = collections.Counter(r[2] for r in inner)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy / 1e9,
        range_device_s=dict(range_s),
        range_calls=dict(calls),
        device_ops=top(op_s),
        idle_gaps=top(gaps),
    )
