"""UDP streaming datapath: encoder -> datagrams -> reorder buffer -> decode.

Counterpart of ``ldpc_erasure_codes_tpu/utils/udp.py`` (:1-567):
``set_rcvbuf`` (:45), ``send_blocks`` (:58, with the JAX package's seeded
NumPy loss and shuffle), ``UdpReceiver`` (:136; GRO, native and Python
drains), ``StreamResult`` (:340), ``_vita_leg`` (:354) and
``loopback_demo`` (:445), whose decode stage runs the port's encoder and
hybrid decoder on ``device`` (the card unless the caller passes a CPU
device). The host side (sockets, NumPy buffers, the C++ reassembler of
``utils/native.py``) is the JAX package's.

The reference's production encoder emits real UDP datagrams carrying an
8-byte FEC header ahead of each symbol payload
(OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136; header pack
:112-114), and its decode side sketches reassembly with reordering logic
(ldpc_erasure_decoder_with_reordering_logic.cl:17-26). This module is the
working datapath over real sockets:

* :func:`send_blocks`: packetize encoded codeword blocks
  (``streaming.make_packet``'s layout) and transmit them over a UDP socket,
  with optional deterministic loss injection and reordering (for
  demos/tests; a real lossy network provides its own).
* :class:`UdpReceiver`: background thread draining a bound UDP socket into
  a :class:`streaming.BlockAssembler`.
* :func:`loopback_demo`: end-to-end: encode on the device -> UDP loopback
  -> reassemble -> batched device decode -> bit-exact payload verification;
  returns counters (packets, blocks, recovered, packets/s). Exposed as the
  ``stream`` CLI subcommand.

With ``vita=True`` the demo runs the reference's full chain: the source
symbols first ride a VITA-49 (VRT) stream over a UDP loopback and are
recovered by :class:`utils.vita.VitaIngest` (header strip, packet-count
continuity, context-packet drop) before encoding: the host-side analog of
the kernel's ingest loop (ldpc_erasure_encoder_VITA_in_UDP_out.cl:140-212).

Words: the wire carries little-endian uint32 words; the port's words are
int32 tensors with the same bits. The two meet by ``.view`` only.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import threading
import time

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.utils import native
from ldpc_erasure_codes_tpu_torch.utils.streaming import (
    BlockAssembler,
    HEADER_BYTES,
    make_assembler,
)
from ldpc_erasure_codes_tpu_torch.utils.vita import VitaEmitter, VitaIngest


def set_rcvbuf(sock: socket.socket, nbytes: int) -> int:
    """Size a socket receive buffer, exceeding ``net.core.rmem_max`` when
    privileged (SO_RCVBUFFORCE needs CAP_NET_ADMIN; plain SO_RCVBUF is
    silently capped at rmem_max, ~208 KB on a stock kernel). Returns the
    size actually granted (the kernel doubles the request)."""
    so_rcvbufforce = getattr(socket, "SO_RCVBUFFORCE", 33)
    try:
        sock.setsockopt(socket.SOL_SOCKET, so_rcvbufforce, nbytes)
    except OSError:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)


def flow_window(rcvbuf: int, datagram_bytes: int) -> int:
    """Datagrams in flight that fit half of a granted receive queue of
    ``rcvbuf`` bytes. The kernel charges a queued datagram the true size of
    its buffer, not its payload: on loopback about twice the datagram plus
    ~1 KB of socket-buffer overhead (a 1032-byte datagram takes ~2.3 KB).
    The JAX package counts payload bytes with a floor of 512 datagrams
    (``udp.py:521``), which overflows a stock ~416 KB queue at 1 KB
    datagrams, and its VITA leg sends without flow control; both drop
    datagrams on a lossless loopback."""
    return max(16, rcvbuf // (2 * (2 * datagram_bytes + 1024)))


def send_order(count: int, *, loss: float = 0.0, shuffle: bool = False,
               seed: int = 0) -> np.ndarray:
    """The flat (block * n + symbol) indices :func:`send_blocks` transmits,
    in order: those that survive ``loss``, shuffled, both drawn from
    ``np.random.default_rng(seed)`` as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    order = np.arange(count, dtype=np.int64)
    if loss > 0.0:
        order = order[rng.random(count) >= loss]
    if shuffle:
        rng.shuffle(order)
    return order


def send_blocks(
    sock: socket.socket,
    addr: tuple[str, int],
    blocks: np.ndarray,
    *,
    class_code: int = 0,
    first_block_num: int = 0,
    loss: float = 0.0,
    shuffle: bool = False,
    seed: int = 0,
    window: int = 0,
    wait=None,
    feedback=None,
) -> int:
    """Packetize and transmit encoded blocks (B, n, symbol_bytes) uint8.

    Returns the number of datagrams actually sent. ``loss`` drops packets
    deterministically (seeded), ``shuffle`` reorders the whole stream —
    both model the network for loopback demos.

    Transmission: the fused packetize + GSO gather
    (``native.udp_send_blocks_gso``) where the kernel has UDP GSO, else one
    native C packetizing pass over the block matrix
    (``native.tx_packetize``) and ``sendmmsg`` bursts, one syscall per 512
    datagrams (``native.udp_send_burst``), else a per-datagram ``sendto``
    loop (no native toolchain); :func:`tx_path` says which ran. The
    reference's TX side is line-rate hardware
    (ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136).

    ``window`` + ``wait`` add application-level flow control for loopback
    runs: at most ``window`` datagrams are in flight beyond what the
    receiver has drained. ``wait(n, timeout)`` blocks until the receiver
    has drained ``n`` datagrams of this stream (:meth:`UdpReceiver.wait_for`
    on a fresh receiver), woken by the drain rather than polling a count
    with a sleep as JAX's ``feedback`` does. ``feedback()``, the
    receiver's drained-datagram count, is JAX's form and polls that count
    every 0.2 ms (udp.py:121-129); pass ``wait`` or ``feedback``, not both.
    Without flow control the
    sendmmsg burst outruns the RX drain and the kernel drops at the socket
    queue once the stream exceeds the receive buffer (loss injection
    happens *before* transmission, so every transmitted datagram is
    expected to arrive on a loopback).
    """
    if wait is not None and feedback is not None:
        raise ValueError("pass wait or feedback, not both")
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    b, n, _sb = blocks.shape
    order = send_order(b * n, loss=loss, shuffle=shuffle, seed=seed)

    def send_slice(order_slice: np.ndarray) -> int:
        cnt = native.udp_send_blocks_gso(
            sock.fileno(), blocks, order_slice, addr[0], addr[1],
            class_code=class_code, first_block_num=first_block_num,
        )
        if cnt is not None:
            return cnt
        # No native toolchain / no kernel GSO: materialized packet matrix.
        pkts = native.tx_packetize(
            blocks, order_slice, class_code=class_code,
            first_block_num=first_block_num,
        )
        cnt = native.udp_send_burst(sock.fileno(), pkts, addr[0], addr[1])
        if cnt is None:  # plain per-datagram Python loop
            for p in pkts:
                sock.sendto(p.tobytes(), addr)
            cnt = len(pkts)
        return cnt

    if not window or (wait is None and feedback is None):
        return send_slice(order)
    base = feedback() if feedback is not None else 0
    sent = 0
    for lo in range(0, len(order), window):
        sent += send_slice(order[lo : lo + window])
        if wait is not None:
            wait(sent - window, 5.0)
            continue
        deadline = time.monotonic() + 5.0
        while sent - (feedback() - base) > window and time.monotonic() < deadline:
            time.sleep(0.0002)
    return sent


def tx_path() -> str:
    """The transmit path :func:`send_blocks` takes in this process:
    ``"gso"`` (fused packetize + UDP GSO), ``"sendmmsg"`` (once a kernel
    rejected GSO, latched in ``native``) or ``"sendto"`` (no native
    library)."""
    if not native.have_native():
        return "sendto"
    return "sendmmsg" if native._GSO_BROKEN else "gso"


class UdpReceiver:
    """Background receive thread feeding a BlockAssembler.

    Bind with port 0 to get an ephemeral port (``.addr``). Stop with
    ``.close()``; the assembler is available as ``.assembler``.
    """

    def __init__(
        self,
        assembler: BlockAssembler,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        rcvbuf: int = 1 << 26,
        burst: int = 256,
    ):
        self.assembler = assembler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rcvbuf = set_rcvbuf(self._sock, rcvbuf)
        # UDP_GRO: the kernel hands the drain whole GSO super-chunks (up to
        # 61 datagrams per recv on loopback) instead of re-segmenting —
        # the RX mirror of the sender's UDP_SEGMENT path.
        self._gro = False
        if native.have_native():
            try:
                self._sock.setsockopt(
                    socket.IPPROTO_UDP, getattr(socket, "UDP_GRO", 104), 1
                )
                self._gro = True
            except OSError:  # pragma: no cover - kernel-dependent
                pass
        self._sock.bind((host, port))
        self._sock.settimeout(0.05)
        self.addr = self._sock.getsockname()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # Notified, under _lock, each time the drain counts datagrams.
        self._arrived = threading.Condition(self._lock)
        self.datagrams = 0
        # Burst buffer: exact-size datagrams accumulate here and flush to the
        # assembler in one call, so the native burst assembler pays its
        # ctypes/FFI entry once per `burst` packets, not once per packet
        # (per-packet FFI measured slower than the pure-Python assembler).
        self._burst_cap = burst if hasattr(assembler, "push_burst") else 0
        if self._burst_cap:
            size = HEADER_BYTES + assembler.symbol_bytes
            self._burst_buf = np.empty((self._burst_cap, size), dtype=np.uint8)
            self._burst_n = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def path(self) -> str:
        """The receive drain: ``"gro"`` (GRO chunks), ``"recvmmsg"`` (native
        bursts) or ``"recvfrom"`` (the Python loop)."""
        if self._gro:
            return "gro"
        return "recvmmsg" if native.have_native() else "recvfrom"

    def _flush_burst_locked(self) -> None:
        if self._burst_cap and self._burst_n:
            self.assembler.push_burst(self._burst_buf[: self._burst_n])
            self._burst_n = 0

    def _run(self) -> None:
        size = HEADER_BYTES + self.assembler.symbol_bytes
        if self._gro:
            self._run_gro(size)
            return
        if native.have_native():
            self._run_native(size)
            return
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(size + 64)
            except socket.timeout:
                with self._lock:
                    self._flush_burst_locked()
                continue
            except OSError:
                break
            with self._lock:
                self.datagrams += 1
                self._arrived.notify_all()
                if self._burst_cap and len(data) == size:
                    self._burst_buf[self._burst_n] = np.frombuffer(
                        data, dtype=np.uint8
                    )
                    self._burst_n += 1
                    if self._burst_n == self._burst_cap:
                        self._flush_burst_locked()
                else:
                    self._flush_burst_locked()  # preserve arrival order
                    self.assembler.push(data)

    def _run_gro(self, size: int) -> None:
        """GRO-chunk drain: one recvmmsg row may carry a kernel-coalesced
        run of up to 61 equal-size datagrams, which IS the assembler burst
        API's packet-matrix layout — a whole GSO send flows kernel -> buf
        row -> native assembler with one FFI call and no per-datagram
        Python work."""
        import select

        cap = 64
        buf = np.empty((cap, 65536 + 128), dtype=np.uint8)
        sizes = np.empty(cap, dtype=np.int32)
        segs = np.empty(cap, dtype=np.int32)
        fd = self._sock.fileno()
        burstable = hasattr(self.assembler, "push_burst")
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select([self._sock], [], [], 0.05)
            except (OSError, ValueError):
                break
            if not ready:
                continue
            try:
                n = native.udp_recv_gro(fd, buf, sizes, segs)
            except OSError:
                break
            if not n:
                continue
            with self._lock:
                i = 0
                while i < n:
                    ln = int(sizes[i])
                    seg = int(segs[i]) or ln
                    if burstable and ln == size and segs[i] in (0, size):
                        # A run of single datagrams (a sender without GSO):
                        # one burst, not one FFI call a datagram.
                        j = i + 1
                        while j < n and sizes[j] == size and segs[j] in (0, size):
                            j += 1
                        self.assembler.push_burst(buf[i:j, :size])
                        self.datagrams += j - i
                        i = j
                        continue
                    if seg == size and ln % size == 0:
                        cnt = ln // size
                        rows = buf[i, :ln].reshape(cnt, size)
                        if burstable:
                            self.assembler.push_burst(rows)
                        else:
                            for r in range(cnt):
                                self.assembler.push(bytes(rows[r]))
                        self.datagrams += cnt
                    else:  # odd-size datagram(s): split at the cmsg size
                        pos = 0
                        while pos < ln:
                            end = min(pos + seg, ln)
                            self.assembler.push(bytes(buf[i, pos:end]))
                            self.datagrams += 1
                            pos = end
                    i += 1
                self._arrived.notify_all()

    def _run_native(self, size: int) -> None:
        """recvmmsg burst drain: one syscall per 512 datagrams straight
        into a matrix the assembler's burst API consumes (the Python
        per-datagram recvfrom loop is an order of magnitude slower than
        both the native assembler and the native sendmmsg TX)."""
        import select

        cap = max(self._burst_cap, 1024)
        buf = np.empty((cap, size + 64), dtype=np.uint8)
        sizes = np.empty(cap, dtype=np.int32)
        fd = self._sock.fileno()
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select([self._sock], [], [], 0.05)
            except (OSError, ValueError):
                break
            if not ready:
                continue
            try:
                n = native.udp_recv_burst(fd, buf, sizes)
            except OSError:
                break
            if not n:
                continue
            with self._lock:
                self.datagrams += n
                # Push contiguous exact-size runs as bursts (arrival order
                # preserved); odd-size datagrams go through push().
                i = 0
                while i < n:
                    if sizes[i] == size:
                        j = i
                        while j < n and sizes[j] == size:
                            j += 1
                        if hasattr(self.assembler, "push_burst"):
                            self.assembler.push_burst(buf[i:j, :size])
                        else:
                            for r in range(i, j):
                                self.assembler.push(bytes(buf[r, :size]))
                        i = j
                    else:
                        self.assembler.push(bytes(buf[i, : sizes[i]]))
                        i += 1
                self._arrived.notify_all()

    def drain(self, max_batch: int | None = None):
        with self._lock:
            self._flush_burst_locked()
            return self.assembler.drain(max_batch)

    def wait_for(self, datagrams: int, timeout: float = 10.0) -> bool:
        """Block until at least ``datagrams`` arrived (or timeout), woken by
        the drain."""
        with self._arrived:
            return self._arrived.wait_for(lambda: self.datagrams >= datagrams, timeout)

    def flush(self) -> None:
        with self._lock:
            self._flush_burst_locked()
            self.assembler.flush()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close()


@dataclasses.dataclass
class StreamResult:
    blocks: int
    packets_sent: int
    packets_received: int
    blocks_recovered: int
    blocks_failed: int
    send_seconds: float
    packets_per_sec: float
    stats: dict
    vita_stats: dict | None = None
    payload_gbps: float = 0.0  # received payload bits / transfer wall time
    transfer_complete: bool = True  # every transmitted datagram arrived
    decode_ms: float = 0.0  # hybrid_decode: CUDA events on a card, else host clock
    # Which host paths ran: "assembler" (native or python), "tx" (see
    # tx_path) and "rx" (UdpReceiver.path).
    paths: dict = dataclasses.field(default_factory=dict)


def _vita_leg(
    src_bytes: np.ndarray, *, stream_id: int, data_per_context: int
) -> tuple[np.ndarray, dict]:
    """Send source symbols as a VRT stream over UDP loopback; ingest back.

    ``src_bytes`` is (blocks, k, symbol_bytes) uint8. Returns the recovered
    array (bit-exact, asserted by the caller) and the ingest stats. Loopback
    UDP is lossless and ordered; upstream-loss detection (packet-count gaps)
    is unit-tested separately (tests/test_torch_vita.py).
    """
    blocks, k, sb = src_bytes.shape
    emitter = VitaEmitter(stream_id, data_per_context=data_per_context)
    ingest = VitaIngest(expected_stream_id=stream_id)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    window = flow_window(set_rcvbuf(rx, 1 << 26), 8 + sb)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.05)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = rx.getsockname()

    # Drain concurrently with the send, windowed by what the drain has
    # ingested (flow_window): the stream must never be required to fit the
    # socket receive queue (SO_RCVBUF requests are silently capped by
    # net.core.rmem_max, ~208 KB on stock Linux), and the Python drain is
    # slower than the GSO sender.
    payloads: list[bytes] = []
    stop = threading.Event()
    # The drain notifies ``ingested`` once it has ingested ``need[0]``
    # datagrams, the count the sender waits for (none while it sends, so
    # the drain takes no lock a datagram).
    ingested = threading.Condition()
    need = [math.inf]

    def _take(data: bytes) -> None:
        p = ingest.push(data)
        if p is not None:
            payloads.append(p)

    def _notify() -> None:
        if ingest.stats["packets"] >= need[0]:
            with ingested:
                ingested.notify_all()

    def _drain() -> None:
        if native.have_native():
            _drain_bursts()
            return
        while True:
            try:
                data, _ = rx.recvfrom(65536)
            except socket.timeout:
                if stop.is_set():
                    return
                continue
            except OSError:
                return
            _take(data)
            _notify()

    def _drain_bursts() -> None:
        # recvmmsg: one syscall (and one GIL release) per burst of up to
        # 256 datagrams, not one a datagram.
        import select

        buf = np.empty((256, 65536), dtype=np.uint8)
        sizes = np.empty(256, dtype=np.int32)
        while True:
            try:
                ready, _, _ = select.select([rx], [], [], 0.05)
                n = native.udp_recv_burst(rx.fileno(), buf, sizes) if ready else 0
            except (OSError, ValueError):
                return
            if not n:
                if not ready and stop.is_set():
                    return
                continue
            for i in range(n):
                _take(buf[i, : sizes[i]].tobytes())
            _notify()

    def wait_ingested(n: int, timeout: float) -> bool:
        with ingested:
            need[0] = n
            ok = ingested.wait_for(lambda: ingest.stats["packets"] >= n, timeout)
            need[0] = math.inf
            return ok

    drainer = threading.Thread(target=_drain, daemon=True)
    drainer.start()
    nsent = 0
    try:
        # Batched VRT framing (one NumPy pass) + sendmmsg bursts, with the
        # context-packet cadence preserved by splitting the data stream at
        # each context's position (a per-packet struct+sendto loop was the
        # measured end-to-end TX bottleneck in the JAX package).
        flat = src_bytes.reshape(blocks * k, sb)
        pkts, contexts = emitter.emit_burst(flat)

        def send_range(lo: int, hi: int) -> None:
            # At most ``window`` datagrams past what the drain has ingested.
            nonlocal nsent
            for a in range(lo, hi, window):
                rows = pkts[a : min(a + window, hi)]
                sent = native.udp_send_gso(tx.fileno(), rows, addr[0], addr[1])
                if sent is None:  # no native toolchain
                    for row in rows:
                        tx.sendto(row.tobytes(), addr)
                    sent = len(rows)
                nsent += sent
                if nsent - ingest.stats["packets"] > window:
                    wait_ingested(nsent - window, 5.0)

        pos = 0
        for i, _cls, cpkt in contexts:
            send_range(pos, i)
            tx.sendto(cpkt, addr)
            nsent += 1
            pos = i
        send_range(pos, len(pkts))
        wait_ingested(nsent, 10.0)
    finally:
        stop.set()
        drainer.join(timeout=2.0)
        tx.close()
        rx.close()
    if ingest.stats["packets"] < nsent:  # pragma: no cover - loopback
        raise RuntimeError(
            f"VITA leg: {ingest.stats['packets']}/{nsent} datagrams arrived"
        )
    out = np.frombuffer(b"".join(payloads), dtype=np.uint8).reshape(
        blocks, k, sb
    )
    return out, dict(ingest.stats)




def _wire_bytes(words: torch.Tensor) -> np.ndarray:
    """int32 words on any device -> their little-endian bytes on the host,
    (..., 4W) uint8: the tensor's bits viewed, never converted."""
    host = np.ascontiguousarray(words.cpu().numpy()).view("<u4")
    return host.view(np.uint8).reshape(*words.shape[:-1], 4 * words.shape[-1])


def _port_words(wire: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., 4W) uint8 wire bytes -> (..., W) int32 words on ``device``
    (the bytes viewed as ``<u4``, then as int32)."""
    wire = np.ascontiguousarray(wire)
    if not wire.flags.writeable:  # bytes joined from datagrams (the VITA leg)
        wire = wire.copy()
    words = wire.view("<u4").view(np.int32).reshape(*wire.shape[:-1], wire.shape[-1] // 4)
    return torch.from_numpy(words).to(device)


def _assert_bytes_equal(got: np.ndarray, want: np.ndarray, msg: str) -> None:
    """Bit-exact, as ``np.testing.assert_array_equal`` holds it, which
    reports the failure; its checks, many times slower than
    ``np.array_equal`` on a GB of bytes, run only then."""
    if not np.array_equal(got, want):
        np.testing.assert_array_equal(got, want, err_msg=msg)
        raise AssertionError(msg)  # shapes equal, values equal: unreachable


def _timed_decode(device: torch.device, fn):
    """(fn(), milliseconds): CUDA events on a card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def loopback_demo(
    code_name: str = "n2000_k1000",
    *,
    blocks: int = 8,
    symbol_words: int = 2,
    loss: float = 0.1,
    shuffle: bool = True,
    seed: int = 0,
    peel_iters: int = 50,
    emax: int = 128,
    assembler: str = "auto",
    vita: bool = False,
    data_per_context: int = 16,
    device: torch.device | str | None = None,
) -> StreamResult:
    """Encode -> UDP loopback (lossy, reordered) -> reassemble -> decode.

    The source words come from a ``torch.Generator`` on ``device`` seeded
    with ``seed``; the encode (``encode_packed``) and the decode
    (``hybrid_decode(peel_iters=, emax=)`` with JAX's default ``impl``) run
    on ``device``: the card when it is None (raises where there is none), a
    CPU device where the caller passes one. The erasure pattern is the
    JAX package's for the same ``seed``, ``loss`` and ``shuffle``
    (``send_blocks`` draws it from NumPy), so the counters are too.

    Every block whose decode did not fail is verified bit-exact, as bytes,
    against the transmitted codeword. Reference datapath:
    ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136 (send side),
    ldpc_erasure_decoder_with_reordering_logic.cl:17-26 (reassembly).
    ``vita=True`` prepends the reference's ingest leg: the source symbols
    arrive as a VITA-49 stream over UDP and are recovered bit-exactly by
    VitaIngest before encoding (:140-212).
    """
    from ldpc_erasure_codes_tpu_torch.codes.io import get_code
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, random_words
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
    from ldpc_erasure_codes_tpu_torch.utils.device import cuda_device

    device = cuda_device() if device is None else torch.device(device)
    code = get_code(code_name)
    arrays = code_arrays(code, device)
    w = symbol_words
    sb = 4 * w
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src = random_words((blocks, code.k, w), gen, device)
    vita_stats = None
    if vita:
        # Reference ingest leg: source symbols ride a VRT stream first.
        src_np = _wire_bytes(src)
        got, vita_stats = _vita_leg(
            src_np, stream_id=0xCC01 + seed, data_per_context=data_per_context
        )
        _assert_bytes_equal(got, src_np, "VITA leg corrupt")
        src = _port_words(got, device)
    wire = _wire_bytes(encode_packed(arrays, src))  # (B, n, sb)

    if assembler == "python":
        asm = BlockAssembler(
            code.n, code.k, sb, max_blocks=blocks, decode_at_k=False
        )
    else:
        asm = make_assembler(
            code.n, code.k, sb, max_blocks=blocks, decode_at_k=False,
            prefer_native=True,
        )
    rx = UdpReceiver(asm)
    rx_path = rx.path
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    # Flow control: cap in-flight datagrams at half the granted receive
    # queue so the native sendmmsg burst (which outruns the RX drain) never
    # overflows it — loopback transport is lossless, so any kernel drop is
    # a self-inflicted measurement artifact, not channel loss.
    window = flow_window(rx.rcvbuf, HEADER_BYTES + sb)
    t0 = time.perf_counter()
    sent = send_blocks(
        tx, rx.addr, wire, loss=loss, shuffle=shuffle, seed=seed + 1,
        window=window, wait=rx.wait_for,
    )
    complete = rx.wait_for(sent, timeout=30.0)
    # Transfer time = send start -> last datagram observed (wait_for wakes
    # on the drain that counts it).
    transfer_dt = time.perf_counter() - t0
    tx.close()
    rx.flush()
    nums, vals, erased = rx.drain()
    received = rx.datagrams
    rx.close()

    values = _port_words(vals, device)
    del vals
    (v, _e, _iters, failed), decode_ms = _timed_decode(device, lambda: hybrid_decode(
        arrays, values, torch.from_numpy(erased).to(device), peel_iters=peel_iters, emax=emax
    ))
    got = _wire_bytes(v)
    del v, values
    failed = failed.cpu().numpy()
    keep = ~failed  # one check over every recovered block
    _assert_bytes_equal(got[keep], wire[np.asarray(nums, dtype=np.int64)[keep]],
                        "a recovered block's payload differs from its codeword")
    recovered = int(keep.sum())
    return StreamResult(
        blocks=blocks,
        packets_sent=sent,
        packets_received=received,
        blocks_recovered=recovered,
        blocks_failed=int(failed.sum()),
        send_seconds=transfer_dt,
        packets_per_sec=received / transfer_dt if transfer_dt > 0 else 0.0,
        stats=dict(asm.stats),
        vita_stats=vita_stats,
        payload_gbps=(
            received * sb * 8 / transfer_dt / 1e9 if transfer_dt > 0 else 0.0
        ),
        transfer_complete=complete,
        decode_ms=decode_ms,
        paths={
            "assembler": "python" if isinstance(asm, BlockAssembler) else "native",
            "tx": tx_path(),
            "rx": rx_path,
        },
    )
