"""Stream milliseconds per ``rs`` call outside the three GF(256) kernels'
stages: the program's span ``rs.decode`` less its ``ge.elim``,
``ge.syndrome`` and ``ge.apply`` (so the cube, the transforms' unpack, the
checks and the gaps between), over the calls of ``rs.decode``."""

from codec_bench.metrics import _spans

UNIT = "ms"
KERNEL_STAGES = ("rs.decode/ge.elim", "rs.decode/ge.syndrome", "rs.decode/ge.apply")


def read(run):
    from ldpc_erasure_codes_tpu_torch.utils import profiling

    found = _spans.record(profiling, run, "rs", "rs.decode")
    if found is None:
        return None
    rec, calls = found
    whole = _spans.stream_ms(rec, ["rs.decode"])
    stages = _spans.stream_ms(rec, KERNEL_STAGES)
    return None if whole is None or stages is None else (whole - stages) / calls
