"""Device milliseconds per call of everything launched inside the ``rs``
calls (``rs_decode_wide``: the cube, ``gf256_eliminate``, ``gf_matvec_wide``,
``gf_apply_scatter`` and their glue)."""

UNIT = "ms"


def read(run):
    dev = run.layer_device_s("rs")
    return None if dev is None else 1e3 * dev / run.calls("rs")
