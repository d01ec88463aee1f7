"""Stream milliseconds per ``hybrid`` call in the hybrid's peel: the
program's span ``hybrid.decode/hybrid.peel`` (CUDA events on the stream at
its enter and exit), over the calls of ``hybrid.decode``."""

from codec_bench.metrics import _spans

UNIT = "ms"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "hybrid", "hybrid.decode")
    if found is None:
        return None
    rec, calls = found
    ms = _spans.stream_ms(rec, ["hybrid.decode/hybrid.peel"])
    return None if ms is None else ms / calls
