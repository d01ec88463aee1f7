"""Host milliseconds per ``hybrid`` call spent at the program's own host
syncs: the program's spans ``hybrid.sync.*`` (the residual's ``any``, the
failures' ``any``, escalation's ``nonzero`` and its residual's ``max``) on
the host clock, over the calls of ``hybrid.decode``."""

from codec_bench.metrics import _spans

UNIT = "ms"


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "hybrid", "hybrid.decode")
    if found is None:
        return None
    rec, calls = found
    host_s = sum(s["host_s"] for path, s in rec["spans"].items()
                 if path.startswith("hybrid.decode/")
                 and path.rsplit("/", 1)[1].startswith("hybrid.sync."))
    return 1e3 * host_s / calls
