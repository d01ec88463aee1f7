"""ctypes loader for the native C++ IO library.

Counterpart of ``ldpc_erasure_codes_tpu/utils/native.py`` (:38-478), whole:
the loader, the vector-file and symbol helpers, the bit-plane transpose,
the Vlist header writer and parser, and the UDP burst wrappers, over the
port's own copy of the source, ``ldpc_erasure_codes_tpu_torch/native/
ldpc_io.cpp``. The shared library is compiled with the system ``g++`` at
first use into ``ldpc_erasure_codes_tpu_torch/build/``, keyed by a hash of
the source, as the CUDA kernels are (``ops/_build.py``). Every entry point
has a NumPy fallback for hosts without ``g++``, which writes and reads the
same bytes; :func:`have_native` says which one runs. This is host I/O (the
analog of the reference's C++ host harness, OpenCL/host/src/main.cpp), not
a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from ldpc_erasure_codes_tpu_torch.ops._build import BUILD_DIR

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "ldpc_io.cpp"


@functools.lru_cache(maxsize=1)
def load_native() -> ctypes.CDLL | None:
    """Compile (if needed) and load the shared library; None on failure."""
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha1(src).hexdigest()[:16]
    so = pathlib.Path(BUILD_DIR) / f"libldpc_io_{tag}.so"
    if not so.exists():
        # Each process compiles to its own file and renames it into place,
        # so concurrent first uses (test workers) never load a partial one.
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
        try:
            so.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u16p = ctypes.POINTER(ctypes.c_uint16)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ldpc_read_vector_file.argtypes = [ctypes.c_char_p, c_u16p, ctypes.c_int]
    lib.ldpc_write_vector_file.argtypes = [ctypes.c_char_p, c_u16p, ctypes.c_int]
    lib.ldpc_expand_symbols.argtypes = [c_u16p, ctypes.c_int, ctypes.c_int, c_u32p, c_u8p]
    lib.ldpc_collapse_symbols.argtypes = [c_u32p, ctypes.c_int, ctypes.c_int, c_u16p]
    lib.ldpc_pack_bitplanes.argtypes = [c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_u32p]
    lib.ldpc_unpack_bitplanes.argtypes = [c_u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_u8p]
    lib.ldpc_write_vlist_header.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ldpc_parse_vlist_header.argtypes = [ctypes.c_char_p, c_i32p, ctypes.c_int]
    c_i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.ldpc_asm_create.restype = ctypes.c_void_p
    lib.ldpc_asm_create.argtypes = [ctypes.c_int] * 5
    lib.ldpc_asm_destroy.argtypes = [ctypes.c_void_p]
    lib.ldpc_asm_push.argtypes = [
        ctypes.c_void_p, c_u8p, c_i32p, ctypes.c_int, ctypes.c_int,
    ]
    lib.ldpc_asm_ready.argtypes = [ctypes.c_void_p]
    lib.ldpc_asm_flush.argtypes = [ctypes.c_void_p]
    lib.ldpc_asm_drain.argtypes = [
        ctypes.c_void_p, c_i64p, c_u8p, c_u8p, ctypes.c_int,
    ]
    lib.ldpc_asm_stats.argtypes = [ctypes.c_void_p, c_i64p]
    lib.ldpc_tx_packetize.argtypes = [
        c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, c_i64p, ctypes.c_int, c_u8p,
    ]
    lib.ldpc_udp_send_burst.argtypes = [
        ctypes.c_int, c_u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ldpc_udp_send_gso.argtypes = lib.ldpc_udp_send_burst.argtypes
    lib.ldpc_udp_send_gso_gather.argtypes = [
        ctypes.c_int, c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, c_i64p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ldpc_udp_recv_burst.argtypes = [
        ctypes.c_int, c_u8p, ctypes.c_int, ctypes.c_int, c_i32p,
    ]
    lib.ldpc_udp_recv_gro.argtypes = [
        ctypes.c_int, c_u8p, ctypes.c_int, ctypes.c_int, c_i32p, c_i32p,
    ]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def have_native() -> bool:
    """Whether the native library is loaded (else the NumPy fallbacks run)."""
    return load_native() is not None


# ---------------------------------------------------------------------------
# Vector files (reference format: one decimal uint16 per line, 0 = erasure)
# ---------------------------------------------------------------------------


def read_vector_file(path: str | os.PathLike, max_n: int = 1 << 20) -> np.ndarray:
    lib = load_native()
    if lib is not None:
        out = np.empty(max_n, dtype=np.uint16)
        cnt = lib.ldpc_read_vector_file(str(path).encode(), _ptr(out, ctypes.c_uint16), max_n)
        if cnt < 0:
            raise OSError(f"cannot read {path}")
        return out[:cnt].copy()
    vals = []
    with open(path) as f:
        for line in f:
            tok = line.replace(",", " ").split()
            if tok:
                vals.append(int(tok[0]) & 0xFFFF)
    return np.asarray(vals, dtype=np.uint16)


def write_vector_file(path: str | os.PathLike, vals: np.ndarray) -> None:
    vals = np.ascontiguousarray(vals, dtype=np.uint16)
    lib = load_native()
    if lib is not None:
        if lib.ldpc_write_vector_file(str(path).encode(), _ptr(vals, ctypes.c_uint16), len(vals)) < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for v in vals:
            f.write(f"{int(v)}\n")


def expand_symbols(vals: np.ndarray, words: int) -> tuple[np.ndarray, np.ndarray]:
    """16-bit values -> ((n, words) uint32 replicated symbols, (n,) bool
    erasure mask); value 0 marks an erasure (main.cpp:380-387)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint16)
    n = len(vals)
    lib = load_native()
    if lib is not None:
        sym = np.empty((n, words), dtype=np.uint32)
        er = np.empty(n, dtype=np.uint8)
        lib.ldpc_expand_symbols(
            _ptr(vals, ctypes.c_uint16), n, words,
            _ptr(sym, ctypes.c_uint32), _ptr(er, ctypes.c_uint8),
        )
        return sym, er.astype(bool)
    v32 = vals.astype(np.uint32)
    word = v32 | (v32 << 16)
    er = vals == 0
    sym = np.where(er[:, None], 0, np.repeat(word[:, None], words, axis=1))
    return sym.astype(np.uint32), er


def collapse_symbols(sym: np.ndarray) -> np.ndarray:
    """(n, words) replicated symbols -> (n,) uint16; raises on lane mismatch."""
    sym = np.ascontiguousarray(sym, dtype=np.uint32)
    n, words = sym.shape
    lib = load_native()
    if lib is not None:
        out = np.empty(n, dtype=np.uint16)
        rc = lib.ldpc_collapse_symbols(_ptr(sym, ctypes.c_uint32), n, words, _ptr(out, ctypes.c_uint16))
        if rc == -2:
            raise ValueError("symbol lanes disagree (replication corrupted)")
        return out
    if np.any(sym != sym[:, :1]) or np.any((sym[:, 0] >> 16) != (sym[:, 0] & 0xFFFF)):
        raise ValueError("symbol lanes disagree (replication corrupted)")
    return (sym[:, 0] & 0xFFFF).astype(np.uint16)


# ---------------------------------------------------------------------------
# Bit-plane <-> packed-word transpose
# ---------------------------------------------------------------------------


def pack_bitplanes(bits: np.ndarray) -> np.ndarray:
    """(b, s, n) {0,1} bytes -> (b, n, s//32) uint32, plane s -> bit (s%32)
    of word (s//32), LSB-first."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    b, s, n = bits.shape
    if s % 32:
        raise ValueError("s must be a multiple of 32")
    lib = load_native()
    if lib is not None:
        out = np.empty((b, n, s // 32), dtype=np.uint32)
        lib.ldpc_pack_bitplanes(_ptr(bits, ctypes.c_uint8), b, s, n, _ptr(out, ctypes.c_uint32))
        return out
    w = s // 32
    planes = bits.reshape(b, w, 32, n).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :, None]
    return (planes * weights).sum(axis=2, dtype=np.uint32).transpose(0, 2, 1).copy()


def unpack_bitplanes(packed: np.ndarray) -> np.ndarray:
    """(b, n, w) uint32 -> (b, 32w, n) {0,1} bytes (inverse of pack)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    b, n, w = packed.shape
    lib = load_native()
    if lib is not None:
        out = np.empty((b, 32 * w, n), dtype=np.uint8)
        lib.ldpc_unpack_bitplanes(_ptr(packed, ctypes.c_uint32), b, 32 * w, n, _ptr(out, ctypes.c_uint8))
        return out
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed.transpose(0, 2, 1)[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return bits.reshape(b, 32 * w, n).astype(np.uint8)


# ---------------------------------------------------------------------------
# Vlist ROM headers
# ---------------------------------------------------------------------------


def write_vlist_header(
    path: str | os.PathLike,
    vlist_idx: np.ndarray,
    vlist_len: np.ndarray,
    array_name: str = "parity_check_mat_Vlist",
    cols: int | None = None,
) -> None:
    """Emit the reference's generated-C Vlist ROM format: one row per check,
    ``{degree, 1-based columns..., 0 padding}``
    (Matlab/data_gen_for_OpenCL_erasure_codec.m:32-50)."""
    vlist_idx = np.ascontiguousarray(vlist_idx, dtype=np.int32)
    vlist_len = np.ascontiguousarray(vlist_len, dtype=np.int32)
    m, dmax = vlist_idx.shape
    cols = cols or dmax + 1
    lib = load_native()
    if lib is not None:
        rc = lib.ldpc_write_vlist_header(
            str(path).encode(), array_name.encode(),
            _ptr(vlist_idx, ctypes.c_int32), _ptr(vlist_len, ctypes.c_int32),
            m, dmax, cols,
        )
        if rc < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        f.write("// generated by ldpc_erasure_codes_tpu (Vlist ROM)\n")
        f.write(f"int {array_name}[{m}][{cols}] = {{\n")
        for r in range(m):
            d = int(vlist_len[r])
            row = [d] + [int(vlist_idx[r, j]) + 1 for j in range(d)]
            row += [0] * (cols - len(row))
            f.write("{" + ",".join(map(str, row)) + "}" + ("," if r + 1 < m else "") + "\n")
        f.write("};\n")


# ---------------------------------------------------------------------------
# Burst transmit (native mirror of the RX-side assembler; see ldpc_io.cpp)
# ---------------------------------------------------------------------------


def tx_packetize(
    blocks: np.ndarray,
    order: np.ndarray,
    *,
    class_code: int = 0,
    first_block_num: int = 0,
) -> np.ndarray:
    """(B, n, sb) uint8 blocks + flat (block*n + symbol) emit order ->
    (npkts, 8 + sb) uint8 contiguous packet matrix (FEC header + payload).

    Loss injection = omit entries from ``order``; stream reordering =
    permute it. One C pass when the native library is available; a
    vectorized NumPy fallback otherwise (identical bytes)."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    b, n, sb = blocks.shape
    order = np.ascontiguousarray(order, dtype=np.int64)
    npkts = len(order)
    out = np.empty((npkts, 8 + sb), dtype=np.uint8)
    lib = load_native()
    if lib is not None and npkts:
        rc = lib.ldpc_tx_packetize(
            _ptr(blocks, ctypes.c_uint8), b, n, sb,
            class_code, first_block_num,
            _ptr(order, ctypes.c_longlong), npkts,
            _ptr(out, ctypes.c_uint8),
        )
        if rc < 0:
            raise ValueError("tx_packetize: order index out of range")
        return out
    blk = (first_block_num + order // n).astype("<u4")
    sym = (order % n).astype("<u2")
    out[:, 0] = class_code & 0xFF
    out[:, 1] = (class_code >> 8) & 0xFF
    out[:, 2:6] = blk.view(np.uint8).reshape(npkts, 4)
    out[:, 6:8] = sym.view(np.uint8).reshape(npkts, 2)
    out[:, 8:] = blocks.reshape(b * n, sb)[order]
    return out


def udp_send_burst(
    fd: int, pkts: np.ndarray, ip: str, port: int
) -> int | None:
    """sendmmsg a (npkts, psize) uint8 packet matrix to ip:port over ``fd``
    (one syscall per 512 datagrams). Returns datagrams sent, or None when
    the native library is unavailable (caller falls back to sendto)."""
    lib = load_native()
    if lib is None:
        return None
    pkts = np.ascontiguousarray(pkts, dtype=np.uint8)
    npkts, psize = pkts.shape
    if npkts == 0:
        return 0
    rc = lib.ldpc_udp_send_burst(
        fd, _ptr(pkts, ctypes.c_uint8), npkts, psize, ip.encode(), port
    )
    if rc < 0:
        raise OSError(f"ldpc_udp_send_burst failed (errno {-rc})")
    return rc


_GSO_BROKEN = False  # latched after one kernel-rejects-GSO failure


def udp_send_gso(
    fd: int, pkts: np.ndarray, ip: str, port: int
) -> int | None:
    """GSO burst transmit: one UDP_SEGMENT super-payload per up-to-61
    consecutive datagrams (zero-copy into the packet matrix), sendmmsg'd
    128 super-payloads per syscall — one skb traverses the UDP stack per
    GROUP, lifting the per-datagram stack cost that bounds plain sendmmsg.
    Falls back to :func:`udp_send_burst` (and latches the fallback) on
    kernels without UDP GSO. Returns datagrams sent, or None when the
    native library is unavailable."""
    global _GSO_BROKEN
    lib = load_native()
    if lib is None:
        return None
    pkts = np.ascontiguousarray(pkts, dtype=np.uint8)
    npkts, psize = pkts.shape
    if npkts == 0:
        return 0
    if not _GSO_BROKEN:
        rc = lib.ldpc_udp_send_gso(
            fd, _ptr(pkts, ctypes.c_uint8), npkts, psize, ip.encode(), port
        )
        if rc >= 0:
            return rc
        _GSO_BROKEN = True  # e.g. EIO/EINVAL: no GSO on this kernel/path
    return udp_send_burst(fd, pkts, ip, port)


def udp_send_blocks_gso(
    fd: int,
    blocks: np.ndarray,
    order: np.ndarray,
    ip: str,
    port: int,
    *,
    class_code: int = 0,
    first_block_num: int = 0,
) -> int | None:
    """Fused packetize + GSO transmit: the kernel gathers each datagram as
    [FEC header | payload row] straight out of the (b, n, sb) block matrix
    via per-segment iovecs — no user-space packet matrix is materialized
    (allocating one measured 0.16 GB/s on first touch, the TX bottleneck
    at 1 KB symbols). ``order`` expresses loss/shuffle as in
    :func:`tx_packetize`. Returns datagrams sent, or None when the native
    library is unavailable or the kernel lacks UDP GSO (caller falls back
    to the packetize path)."""
    global _GSO_BROKEN
    lib = load_native()
    if lib is None or _GSO_BROKEN:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    b, n, sb = blocks.shape
    order = np.ascontiguousarray(order, dtype=np.int64)
    if len(order) == 0:
        return 0
    rc = lib.ldpc_udp_send_gso_gather(
        fd, _ptr(blocks, ctypes.c_uint8), b, n, sb,
        class_code, first_block_num,
        _ptr(order, ctypes.c_longlong), len(order), ip.encode(), port,
    )
    if rc >= 0:
        return rc
    if rc == -1:
        raise ValueError("udp_send_blocks_gso: order index out of range")
    _GSO_BROKEN = True
    return None


def udp_recv_burst(
    fd: int, buf: np.ndarray, sizes: np.ndarray
) -> int | None:
    """Drain ready datagrams from ``fd`` into the (max_pkts, stride) uint8
    matrix ``buf`` via recvmmsg (non-blocking; one syscall per 512).
    ``sizes`` (max_pkts,) int32 receives each datagram's length. Returns the
    count drained (0 = nothing ready), or None when the native library is
    unavailable."""
    lib = load_native()
    if lib is None:
        return None
    rc = lib.ldpc_udp_recv_burst(
        fd, _ptr(buf, ctypes.c_uint8), buf.shape[0], buf.shape[1],
        _ptr(sizes, ctypes.c_int32),
    )
    if rc < 0:
        raise OSError(f"ldpc_udp_recv_burst failed (errno {-rc})")
    return rc


def udp_recv_gro(
    fd: int, buf: np.ndarray, sizes: np.ndarray, segs: np.ndarray
) -> int | None:
    """GRO-aware drain: each filled row of the (max_chunks, stride) uint8
    ``buf`` may hold a kernel-coalesced run of equal-size datagrams (the RX
    mirror of :func:`udp_send_gso`). ``sizes[i]`` = chunk bytes, ``segs[i]``
    = segment size from the UDP_GRO cmsg (0 = ordinary datagram). Returns
    chunks drained, or None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    rc = lib.ldpc_udp_recv_gro(
        fd, _ptr(buf, ctypes.c_uint8), buf.shape[0], buf.shape[1],
        _ptr(sizes, ctypes.c_int32), _ptr(segs, ctypes.c_int32),
    )
    if rc < 0:
        raise OSError(f"ldpc_udp_recv_gro failed (errno {-rc})")
    return rc


def parse_header_ints(path: str | os.PathLike, max_vals: int = 1 << 22) -> np.ndarray:
    """All integers inside the first top-level ``{...}`` array literal."""
    lib = load_native()
    if lib is not None:
        out = np.empty(max_vals, dtype=np.int32)
        cnt = lib.ldpc_parse_vlist_header(str(path).encode(), _ptr(out, ctypes.c_int32), max_vals)
        if cnt < 0:
            raise OSError(f"cannot parse {path}")
        return out[:cnt].copy()
    import re

    text = pathlib.Path(path).read_text()
    text = re.sub(r"//[^\n]*", " ", text)
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    start = text.index("{")
    depth = 0
    end = start
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    return np.asarray(
        [int(x) for x in re.findall(r"-?\d+", text[start : end + 1])],
        dtype=np.int32,
    )
