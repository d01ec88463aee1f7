"""The port's VITA-49 (VRT) framing (``utils/vita.py``) against the JAX
package's.

JAX's ``tests/test_vita.py`` cases run on the port; the port's ``emit`` and
``emit_burst`` datagrams are byte-identical to JAX's on the same payloads,
and ``VitaIngest`` keeps the same stats as JAX's on a stream with gaps,
context packets, wrong streams and bad sizes. Pure host code: exact.
"""

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.utils import vita as jvita
from ldpc_erasure_codes_tpu_torch.utils.vita import (
    CLASS_CONTEXT,
    CLASS_DATA,
    PKT_IF_CONTEXT,
    PKT_IF_DATA,
    PKT_IF_DATA_SID,
    VitaEmitter,
    VitaHeader,
    VitaIngest,
    parse_header,
)


def test_header_roundtrip_all_fields():
    h = VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=11, packet_size=37,
                   has_class_id=False, has_trailer=True, tsi=2, tsf=1, stream_id=0xDEADBEEF)
    got = parse_header(h.pack() + b"\x00" * 4)
    assert got == h
    assert got.header_words == 2


def test_header_roundtrip_no_stream_id():
    h = VitaHeader(packet_type=PKT_IF_DATA, packet_count=3, packet_size=9)
    got = parse_header(h.pack())
    assert got == h
    assert got.header_words == 1
    assert not got.has_stream_id


def test_header_word0_bit_layout():
    h = VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=0xF, packet_size=0x1234,
                   stream_id=1)
    w0 = int.from_bytes(h.pack()[:4], "big")
    assert (w0 >> 28) & 0xF == PKT_IF_DATA_SID
    assert (w0 >> 16) & 0xF == 0xF
    assert w0 & 0xFFFF == 0x1234


@pytest.mark.parametrize("ptype", [PKT_IF_DATA, PKT_IF_DATA_SID, PKT_IF_CONTEXT])
@pytest.mark.parametrize("count,size", [(0, 1), (7, 300), (15, 0xFFFF)])
def test_header_pack_matches_jax(ptype, count, size):
    kw = dict(packet_type=ptype, packet_count=count, packet_size=size, has_trailer=count % 2 == 1,
              tsi=count % 4, tsf=(count // 4) % 4, stream_id=0xAB000000 + count)
    raw = VitaHeader(**kw).pack()
    assert raw == jvita.VitaHeader(**kw).pack()
    assert parse_header(raw + b"\x00" * 4).pack() == jvita.parse_header(raw + b"\x00" * 4).pack()


def test_parse_errors():
    with pytest.raises(ValueError):
        parse_header(b"\x01\x02")
    h = VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=0, packet_size=2, stream_id=5)
    with pytest.raises(ValueError):
        parse_header(h.pack()[:4])
    with pytest.raises(ValueError):
        VitaHeader(packet_type=PKT_IF_DATA, packet_count=16, packet_size=1).pack()


def test_emitter_context_cadence_and_counts():
    em = VitaEmitter(7, data_per_context=3)
    classes, counts = [], []
    for _ in range(10):
        for cls, pkt in em.emit(b"abcd"):
            classes.append(cls)
            counts.append(parse_header(pkt).packet_count)
    assert classes.count(CLASS_CONTEXT) == 3
    assert [c for c in classes if c == CLASS_DATA] == [CLASS_DATA] * 10
    data_counts = [c for cls, c in zip(classes, counts) if cls == CLASS_DATA]
    ctx_counts = [c for cls, c in zip(classes, counts) if cls == CLASS_CONTEXT]
    assert data_counts == [i & 0xF for i in range(10)]
    assert ctx_counts == [0, 1, 2]


@pytest.mark.parametrize("data_per_context,test_mode", [(0, False), (5, False), (3, True)])
def test_emit_matches_jax(data_per_context, test_mode):
    """Sequential ``emit``: the same (class code, datagram) pairs as JAX's."""
    rng = np.random.default_rng(data_per_context)
    ours = VitaEmitter(0xCC01, data_per_context=data_per_context, test_mode=test_mode)
    ref = jvita.VitaEmitter(0xCC01, data_per_context=data_per_context, test_mode=test_mode)
    for _ in range(40):
        p = rng.integers(0, 256, 4 * int(rng.integers(1, 9)), dtype=np.uint8).tobytes()
        assert ours.emit(p) == ref.emit(p)


@pytest.mark.parametrize("data_per_context", [0, 5, 16])
def test_emit_burst_matches_jax(data_per_context):
    """``emit_burst`` in two bursts (counter state carried over): the same
    packet matrix and context list as JAX's, and as sequential ``emit``."""
    payloads = np.random.default_rng(50).integers(0, 256, (37, 12), dtype=np.uint8)
    ours = VitaEmitter(0xAB12, data_per_context=data_per_context)
    ref = jvita.VitaEmitter(0xAB12, data_per_context=data_per_context)
    seq = VitaEmitter(0xAB12, data_per_context=data_per_context)
    flat = []
    for lo, hi in ((0, 17), (17, 37)):
        pkts, ctx = ours.emit_burst(payloads[lo:hi])
        jpkts, jctx = ref.emit_burst(payloads[lo:hi])
        np.testing.assert_array_equal(pkts, jpkts)
        assert ctx == jctx
        by_pos = {i: cp for i, _cls, cp in ctx}
        for i in range(hi - lo):
            if i in by_pos:
                flat.append(by_pos[i])
            flat.append(pkts[i].tobytes())
    want = [pkt for p in payloads for _cls, pkt in seq.emit(p.tobytes())]
    assert flat == want
    assert (ours._data_count, ours._ctx_count, ours._since_context) == (
        seq._data_count, seq._ctx_count, seq._since_context)


def test_emitter_rejects_ragged_payload():
    with pytest.raises(ValueError):
        VitaEmitter(1).emit(b"abc")
    with pytest.raises(ValueError):
        VitaEmitter(1).emit_burst(np.zeros((2, 3), dtype=np.uint8))


def test_ingest_strips_and_drops_context():
    em = VitaEmitter(42, data_per_context=2)
    ing = VitaIngest(expected_stream_id=42)
    payloads = [bytes([i]) * 8 for i in range(6)]
    got = []
    for p in payloads:
        for _cls, pkt in em.emit(p):
            out = ing.push(pkt)
            if out is not None:
                got.append(out)
    assert got == payloads
    assert ing.stats["context"] == 2
    assert ing.stats["count_gaps"] == 0


def test_ingest_detects_upstream_loss():
    em = VitaEmitter(1)
    ing = VitaIngest()
    pkts = [em.emit(bytes([i]) * 4)[0][1] for i in range(8)]
    for i, pkt in enumerate(pkts):
        if i not in (2, 3):
            ing.push(pkt)
    assert ing.stats["count_gaps"] == 1
    assert ing.stats["lost_upstream"] == 2


def test_ingest_rejects_bad_sizes_and_streams():
    ing = VitaIngest(expected_stream_id=9)
    h = VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=0, packet_size=3, stream_id=9)
    assert ing.push(h.pack() + b"1234") == b"1234"
    assert ing.push(h.pack() + b"12345678") is None
    assert ing.stats["bad"] == 1
    wrong = VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=1, packet_size=3, stream_id=8)
    assert ing.push(wrong.pack() + b"1234") is None
    assert ing.stats["wrong_stream"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_ingest_stats_match_jax(seed):
    """A stream with dropped data packets (gaps), context packets, a wrong
    stream, short and mis-sized datagrams through both ingests: the same
    payloads and the same stats."""
    rng = np.random.default_rng(seed)
    em = jvita.VitaEmitter(0x77, data_per_context=4)
    stream = []
    for i in range(60):
        for _cls, pkt in em.emit(rng.integers(0, 256, 16, dtype=np.uint8).tobytes()):
            if rng.random() >= 0.1:  # upstream loss
                stream.append(pkt)
    other = jvita.VitaHeader(packet_type=PKT_IF_DATA_SID, packet_count=0, packet_size=3,
                             stream_id=0x78)
    stream[5:5] = [b"\x01\x02", other.pack() + b"abcd", stream[3] + b"\x00" * 4,
                   stream[4][:-1]]
    ours, ref = VitaIngest(expected_stream_id=0x77), jvita.VitaIngest(expected_stream_id=0x77)
    assert [ours.push(d) for d in stream] == [ref.push(d) for d in stream]
    assert ours.stats == ref.stats
    assert ours.stats["count_gaps"] > 0 and ours.stats["bad"] >= 2
    assert ours.stats["context"] > 0 and ours.stats["wrong_stream"] == 1
