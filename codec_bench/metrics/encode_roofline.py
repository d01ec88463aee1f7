"""Share of its byte roofline that the encode call reaches: the least time to
read the source once and write the codewords once, at the card's published
bandwidth, over the device time of everything launched inside the ``encode``
calls."""

from codec_bench import peaks

UNIT = "%"


def read(run):
    dev = run.layer_device_s("encode")
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if dev is None or peak is None:
        return None
    least = run.batch * (run.k + run.n) * run.words * 4
    return 100.0 * run.calls("encode") * least / peak / dev
