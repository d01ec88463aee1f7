"""Device milliseconds per call of everything launched inside the ``hybrid``
calls (``hybrid_decode_escalated``: the peel, the compacted GE, escalation)."""

UNIT = "ms"


def read(run):
    dev = run.layer_device_s("hybrid")
    return None if dev is None else 1e3 * dev / run.calls("hybrid")
