"""Stream milliseconds per ``hybrid`` call in the first GE dispatch, from
the gather of the residual frames to their scatter back: the program's span
``hybrid.decode/hybrid.ge.<route>`` (``compact``, ``rows`` or ``whole``),
over the calls of ``hybrid.decode``."""

from codec_bench.metrics import _spans

UNIT = "ms"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "hybrid", "hybrid.decode")
    if found is None:
        return None
    rec, calls = found
    ms = _spans.stream_ms(rec, _spans.children(rec, "hybrid.decode", "hybrid.ge."))
    return None if ms is None else ms / calls
