"""Stream milliseconds per ``rs`` call in the syndrome of the received
payloads (``gf_matvec_wide``): the program's span ``rs.decode/ge.syndrome``,
over the calls of ``rs.decode``."""

from codec_bench.metrics import _spans

UNIT = "ms"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "rs", "rs.decode")
    if found is None:
        return None
    rec, calls = found
    ms = _spans.stream_ms(rec, ["rs.decode/ge.syndrome"])
    return None if ms is None else ms / calls
