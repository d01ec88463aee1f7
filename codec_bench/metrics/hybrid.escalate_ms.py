"""Stream milliseconds per ``hybrid`` call in escalation, the second GE
dispatch of the frames the first one's buckets could not hold, its two host
syncs included: the program's span ``hybrid.decode/hybrid.escalate``, over
the calls of ``hybrid.decode`` (0 where no call escalated)."""

from codec_bench.metrics import _spans

UNIT = "ms"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "hybrid", "hybrid.decode")
    if found is None:
        return None
    rec, calls = found
    ms = _spans.stream_ms(rec, ["hybrid.decode/hybrid.escalate"])
    return None if ms is None else ms / calls
