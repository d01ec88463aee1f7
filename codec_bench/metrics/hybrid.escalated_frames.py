"""Frames per ``hybrid`` call that escalation solved again: the program's
counter ``hybrid.escalated_frames``, over the calls of ``hybrid.decode``."""

from codec_bench.metrics import _spans

UNIT = "count"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "hybrid", "hybrid.decode")
    if found is None:
        return None
    rec, calls = found
    return rec["counters"].get("hybrid.escalated_frames", 0) / calls
