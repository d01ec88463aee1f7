"""Device milliseconds per call of everything launched inside the ``sim``
calls (the simulation step: the channel's draws, the mask sweeps' products
with H, the counters)."""

UNIT = "ms"


def read(run):
    dev = run.layer_device_s("sim")
    return None if dev is None else 1e3 * dev / run.calls("sim")
