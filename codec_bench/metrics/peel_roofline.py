"""Share of its byte roofline that the peel call reaches: the least time to
read the received frames and masks once and write the decoded frames, masks
and iteration counts once, at the card's published bandwidth, over the device
time of everything launched inside the ``peel`` calls."""

from codec_bench import peaks

UNIT = "%"


def read(run):
    dev = run.layer_device_s("peel")
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if dev is None or peak is None:
        return None
    b, n, w = run.batch, run.n, run.words
    least = b * n * w * 4 * 2 + b * n * 2 + b * 4
    return 100.0 * run.calls("peel") * least / peak / dev
