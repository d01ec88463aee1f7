"""The port's UDP datapath (``utils/udp.py``) and ``cli stream`` against the
JAX package's, on the CPU.

JAX's ``tests/test_udp.py`` cases run on the port with ``device="cpu"``.
The erasure pattern depends only on ``seed`` (``send_blocks`` draws it from
NumPy as JAX does) and a block's decode failure only on its pattern, so
``loopback_demo`` in both packages, with the same code, seed, loss,
shuffle and ``emax``, must report equal counters (datagrams sent and
received, blocks recovered and failed, the assembler's and the VITA
ingest's stats), with and without the VITA leg; every block that did not
fail is held bit-exactly to its codeword inside the demo.
"""

import json
import socket

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.utils.udp import loopback_demo as jax_loopback_demo
from ldpc_erasure_codes_tpu_torch.utils import cli, native
from ldpc_erasure_codes_tpu_torch.utils.streaming import BlockAssembler, HEADER_BYTES
from ldpc_erasure_codes_tpu_torch.utils.udp import (
    UdpReceiver,
    _vita_leg,
    flow_window,
    loopback_demo,
    send_blocks,
    send_order,
    set_rcvbuf,
)

COUNTERS = ("blocks", "packets_sent", "packets_received", "blocks_recovered", "blocks_failed",
            "stats", "vita_stats", "transfer_complete")


def test_loopback_lossless_in_order():
    r = loopback_demo("n2000_k1000", blocks=3, symbol_words=1, loss=0.0, shuffle=False,
                      device="cpu")
    assert r.packets_sent == 3 * 2000
    assert r.packets_received == r.packets_sent  # loopback: no kernel drops
    assert r.blocks_recovered == 3
    assert r.blocks_failed == 0
    assert r.stats["late"] == 0


def test_loopback_lossy_reordered():
    r = loopback_demo("n2000_k1000", blocks=4, symbol_words=2, loss=0.1, shuffle=True, seed=3,
                      device="cpu")
    assert r.packets_sent < 4 * 2000  # loss actually injected
    assert r.blocks_recovered == 4
    assert r.blocks_failed == 0
    assert r.paths == {"assembler": "native", "tx": r.paths["tx"], "rx": r.paths["rx"]}
    assert r.paths["tx"] in ("gso", "sendmmsg") and r.paths["rx"] in ("gro", "recvmmsg")


@pytest.mark.parametrize("kw", [
    dict(blocks=4, symbol_words=2, loss=0.1, shuffle=True, seed=3),
    dict(blocks=6, symbol_words=1, loss=0.42, shuffle=True, seed=1),  # 2 blocks fail
    dict(blocks=3, symbol_words=1, loss=0.2, shuffle=False, seed=0, assembler="python"),
    dict(blocks=2, symbol_words=1, loss=0.05, shuffle=True, seed=5, vita=True,
         data_per_context=100),
    dict(blocks=2, symbol_words=2, loss=0.3, shuffle=True, seed=2, vita=True, emax=64),
], ids=["lossy", "failing", "python-asm", "vita", "vita-lossy"])
def test_loopback_counters_match_jax(kw):
    ours = loopback_demo("n2000_k1000", device="cpu", **kw)
    ref = jax_loopback_demo("n2000_k1000", **kw)
    for f in COUNTERS:
        assert getattr(ours, f) == getattr(ref, f), f
    if kw["seed"] == 1:
        assert ours.blocks_failed == 2 and ours.blocks_recovered == 4


def test_send_blocks_order_matches_jax_draw():
    """The datagrams sent: NumPy's ``default_rng(seed)`` loss then shuffle,
    one FEC header per (block, symbol) in that order."""
    blocks = np.random.default_rng(9).integers(0, 256, (2, 7, 4), dtype=np.uint8)
    asm = BlockAssembler(7, 4, 4, max_blocks=2, decode_at_k=False)
    rx = UdpReceiver(asm)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sent = send_blocks(tx, rx.addr, blocks, loss=0.3, shuffle=True, seed=4,
                           window=flow_window(rx.rcvbuf, HEADER_BYTES + 4),
                           wait=rx.wait_for)
        assert rx.wait_for(sent, timeout=10.0)
        rx.flush()
        nums, vals, erased = rx.drain()
    finally:
        tx.close()
        rx.close()
    rng = np.random.default_rng(4)
    order = np.arange(14)[rng.random(14) >= 0.3]
    assert sent == len(order)
    want = np.zeros((2, 7), dtype=bool)
    want.reshape(-1)[order] = True
    np.testing.assert_array_equal(~erased, want[nums])
    np.testing.assert_array_equal(vals, np.where(want[nums][:, :, None], blocks[nums], 0))


def test_send_order_is_jax_draw():
    rng = np.random.default_rng(4)
    want = np.arange(14)[rng.random(14) >= 0.3]
    rng.shuffle(want)
    np.testing.assert_array_equal(send_order(14, loss=0.3, shuffle=True, seed=4), want)
    np.testing.assert_array_equal(send_order(5), np.arange(5))


def test_loopback_without_gso(monkeypatch):
    """A sender without UDP GSO (sendmmsg, one datagram a GRO row): the
    receiver takes runs of single datagrams as bursts, and nothing is lost
    or wrong."""
    monkeypatch.setattr(native, "udp_send_blocks_gso", lambda *a, **k: None)
    r = loopback_demo("n2000_k1000", blocks=4, symbol_words=2, loss=0.1, shuffle=True, seed=3,
                      device="cpu")
    assert r.transfer_complete and r.packets_received == r.packets_sent
    assert r.blocks_recovered + r.blocks_failed == 4
    assert r.stats["packets"] == r.packets_sent and r.stats["bad"] == 0


def test_send_blocks_waits_out_its_window():
    """After each slice of ``window`` datagrams the sender waits until the
    receiver has drained all but ``window`` of those sent."""
    blocks = np.random.default_rng(3).integers(0, 256, (2, 7, 4), dtype=np.uint8)
    rx = UdpReceiver(BlockAssembler(7, 4, 4, max_blocks=2, decode_at_k=False))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    waits = []

    def wait(n, timeout):
        waits.append(n)
        return rx.wait_for(n, timeout)

    try:
        sent = send_blocks(tx, rx.addr, blocks, window=3, wait=wait)
        assert rx.wait_for(sent, timeout=10.0)
    finally:
        tx.close()
        rx.close()
    assert sent == 14 and waits == [0, 3, 6, 9, 11]


def test_flow_window_counts_kernel_memory():
    """Half the queue over ~twice the datagram plus 1 KB: a 1032-byte
    datagram stream on a stock 416 KB queue keeps ~67 in flight (the JAX
    formula's floor of 512 would need ~1.2 MB)."""
    assert flow_window(425984, 1032) == 425984 // (2 * 3088) == 68
    assert flow_window(1 << 27, 16) == (1 << 27) // (2 * 1056)
    assert flow_window(4096, 1032) == 16


def test_vita_leg_windowed_at_1kb_symbols():
    """The VITA leg at 1 KB payloads, far past the receive queue: every
    datagram arrives, with no count gap (the JAX leg, unwindowed, loses
    datagrams here once the stream outgrows the queue)."""
    src = np.random.default_rng(2).integers(0, 256, (2, 3000, 1024), dtype=np.uint8)
    got, stats = _vita_leg(src, stream_id=7, data_per_context=16)
    np.testing.assert_array_equal(got, src)
    assert stats["data"] == 6000 and stats["count_gaps"] == 0 and stats["bad"] == 0
    assert stats["context"] == (6000 - 1) // 16


def test_vita_leg_python_drain(monkeypatch):
    """Without the native library the VITA leg drains with ``recvfrom``
    (the native drain takes recvmmsg bursts): the same payloads and stats."""
    src = np.random.default_rng(5).integers(0, 256, (2, 700, 64), dtype=np.uint8)
    want = _vita_leg(src, stream_id=9, data_per_context=16)
    monkeypatch.setattr(native, "have_native", lambda: False)
    got = _vita_leg(src, stream_id=9, data_per_context=16)
    np.testing.assert_array_equal(got[0], src)
    np.testing.assert_array_equal(want[0], src)
    assert got[1] == want[1] and got[1]["count_gaps"] == 0 and got[1]["data"] == 1400


def test_set_rcvbuf_grants_a_size():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert set_rcvbuf(s, 1 << 20) >= 4096
    finally:
        s.close()


def test_stream_cli_smoke(capsys):
    rc = cli.main(["stream", "--code", "n2000_k1000", "--blocks", "2", "--symbol-words", "1",
                   "--loss", "0.05", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["blocks_recovered"] + out["blocks_failed"] == 2
    assert set(out) == {"blocks", "packets_sent", "packets_received", "blocks_recovered",
                        "blocks_failed", "packets_per_sec", "payload_gbps",
                        "transfer_complete", "assembler"}


def test_stream_cli_vita_matches_jax(capsys):
    """``cli stream --vita`` in both packages: the same JSON but for the
    rates."""
    from ldpc_erasure_codes_tpu.utils import cli as jcli

    argv = ["stream", "--code", "n2000_k1000", "--blocks", "1", "--symbol-words", "1",
            "--loss", "0.2", "--vita", "--seed", "4"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for d in (ours, ref):
        del d["packets_per_sec"], d["payload_gbps"]
    assert ours == ref
    assert ours["vita"]["data"] == 1000


def test_stream_without_card_raises(monkeypatch):
    """The default device is the card: without one the command and the demo
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["stream", "--blocks", "1", "--symbol-words", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loopback_demo(blocks=1, symbol_words=1)


def test_native_library_loaded():
    assert native.have_native()
