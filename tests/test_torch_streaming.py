"""The port's block assemblers (``utils/streaming.py``) against the JAX
package's.

JAX's ``tests/test_streaming.py`` cases run on the port; seeded NumPy
packet streams (with duplicates, malformed packets, reordering and every
``(decode_at_k, max_blocks)`` pair) go through JAX's ``BlockAssembler``
and the port's Python and native assemblers, which must agree on stats,
block numbers, values and masks; and the port's ``hybrid_decode`` on the
drained arrays is held to JAX's on the same arrays. Host bookkeeping and
finite-field decode: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import hybrid_decode as jax_hybrid_decode
from ldpc_erasure_codes_tpu.utils import streaming as jstreaming
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu_torch.utils import native
from ldpc_erasure_codes_tpu_torch.utils.streaming import (
    HEADER_BYTES,
    BlockAssembler,
    NativeBlockAssembler,
    make_assembler,
    make_packet,
    pack_header,
    unpack_header,
)
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words

PAIRS = [(True, 3), (False, 3), (False, 1), (False, 0)]


def test_header_roundtrip():
    p = make_packet(3, 0xDEADBEEF, 513, b"\x00" * 4)
    assert len(p) == HEADER_BYTES + 4 == 12
    assert unpack_header(p) == (3, 0xDEADBEEF, 513)
    assert pack_header(3, 0xDEADBEEF, 513) == jstreaming.pack_header(3, 0xDEADBEEF, 513)


def test_out_of_order_assembly():
    n, k, sb = 8, 5, 4
    asm = BlockAssembler(n, k, sb, decode_at_k=False)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, sb, dtype=np.uint8).tobytes() for _ in range(n)]
    for s in rng.permutation(n):
        asm.push(make_packet(0, 7, int(s), payloads[s]))
    assert asm.ready_count == 1
    nums, vals, erased = asm.drain()
    assert nums.tolist() == [7]
    assert not erased.any()
    for s in range(n):
        assert vals[0, s].tobytes() == payloads[s]


def test_decode_at_k_trigger_and_erasures():
    n, k, sb = 10, 6, 2
    asm = BlockAssembler(n, k, sb, decode_at_k=True)
    for s in range(k):  # exactly k packets -> immediate drain
        asm.push(make_packet(0, 1, s, bytes([s, s])))
    assert asm.ready_count == 1
    _, vals, erased = asm.drain()
    np.testing.assert_array_equal(erased[0], [False] * k + [True] * (n - k))
    assert (vals[0, k:] == 0).all()  # erased slots zero (invariant)


def test_eviction_and_flush():
    asm = BlockAssembler(4, 2, 1, max_blocks=2, decode_at_k=False)
    for blk in range(3):  # 3 in-flight blocks with 1 packet each
        asm.push(make_packet(0, blk, 0, b"\x01"))
    assert asm.stats["evictions"] == 1  # oldest force-drained
    asm.flush()
    assert asm.ready_count == 3
    asm.push(make_packet(0, 9, 99, b"\x01"))  # bad symbol index
    asm.push(make_packet(0, 9, 0, b""))  # bad length
    assert asm.stats["bad"] == 2


def test_duplicates_ignored():
    asm = BlockAssembler(4, 2, 1, decode_at_k=False)
    asm.push(make_packet(0, 0, 1, b"\xaa"))
    asm.push(make_packet(0, 0, 1, b"\xbb"))
    assert asm.stats["duplicates"] == 1
    asm.flush()
    _, vals, _ = asm.drain()
    assert vals[0, 1, 0] == 0xAA  # first arrival wins


def test_late_straggler_does_not_duplicate_block():
    n, k, sb = 6, 3, 1
    asm = BlockAssembler(n, k, sb, decode_at_k=True)
    for s in range(k):  # block 5 drains at k packets
        asm.push(make_packet(0, 5, s, bytes([s])))
    asm.push(make_packet(0, 5, k, bytes([k])))  # straggler for block 5
    assert asm.stats["late"] == 1
    asm.flush()
    nums, _, _ = asm.drain()
    assert nums.tolist() == [5]  # exactly one output for block 5


def test_completed_lru_is_bounded():
    """The completed-block LRU keeps max(64, 4 max_blocks) numbers: a
    straggler for a block that has aged out recreates it, one still inside
    counts late (streaming.py:90-94)."""
    asm = BlockAssembler(2, 1, 1, max_blocks=1, decode_at_k=True)
    for blk in range(65):
        asm.push(make_packet(0, blk, 0, b"\x01"))
    assert asm.stats["blocks_out"] == 65
    asm.push(make_packet(0, 1, 1, b"\x01"))  # block 1 is still remembered
    assert asm.stats["late"] == 1
    asm.push(make_packet(0, 0, 1, b"\x01"))  # block 0 aged out of the LRU
    assert asm.stats["late"] == 1 and asm.stats["blocks_out"] == 66


def test_self_eviction_counts_late():
    asm = BlockAssembler(4, 2, 1, max_blocks=0, decode_at_k=False)
    asm.push(make_packet(0, 7, 1, b"\xaa"))
    assert asm.stats["evictions"] == 1
    assert asm.stats["late"] == 1
    assert asm.stats["blocks_out"] == 1  # the empty finished block
    nums, _, erased = asm.drain()
    assert nums.tolist() == [7]
    assert erased.all()  # payload was NOT written into the orphan
    asm.flush()
    assert asm.stats["blocks_out"] == 1


def _random_stream(seed, n=12, k=7, sb=4, nblocks=5, loss=0.2, dup=0.1):
    """JAX's ``tests/test_streaming.py::_random_stream``: lossy, duplicated,
    shuffled, with a bad symbol, a short and an oversized packet."""
    rng = np.random.default_rng(seed)
    packets = []
    for b in range(nblocks):
        for s in range(n):
            if rng.random() < loss:
                continue
            payload = rng.integers(0, 256, sb, dtype=np.uint8).tobytes()
            packets.append(make_packet(0, b, s, payload))
            if rng.random() < dup:
                packets.append(packets[-1])
    rng.shuffle(packets)
    packets.insert(2, make_packet(0, 1, n + 5, b"\x00" * sb))  # bad symbol
    packets.insert(5, b"\x01\x02\x03")  # bad length (short)
    packets.insert(7, make_packet(0, 1, 0, b"\x00" * (sb + 9)))  # oversized
    return n, k, sb, packets


def _drained(asm, packets):
    for p in packets:
        asm.push(p)
    asm.flush()
    return asm.stats, *asm.drain()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("decode_at_k,max_blocks", PAIRS)
def test_assemblers_match_jax(seed, decode_at_k, max_blocks):
    """The same seeded streams through JAX's BlockAssembler and the port's
    Python and native assemblers: equal stats, block numbers, values and
    masks."""
    assert native.have_native(), "the native library did not build"
    n, k, sb, packets = _random_stream(seed)
    kw = dict(max_blocks=max_blocks, decode_at_k=decode_at_k)
    want = _drained(jstreaming.BlockAssembler(n, k, sb, **kw), packets)
    for asm in (BlockAssembler(n, k, sb, **kw), NativeBlockAssembler(n, k, sb, **kw)):
        got = _drained(asm, packets)
        assert got[0] == want[0], type(asm).__name__
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_native_assembler_burst_push():
    n, k, sb = 10, 6, 4
    rng = np.random.default_rng(3)
    rows = [np.frombuffer(make_packet(0, 2, s, rng.integers(0, 256, sb, np.uint8).tobytes()),
                          dtype=np.uint8) for s in range(n)]
    na = NativeBlockAssembler(n, k, sb, decode_at_k=False)
    na.push_burst(np.stack(rows))
    assert na.ready_count == 1
    nums, vals, er = na.drain()
    assert nums.tolist() == [2]
    assert not er.any()
    np.testing.assert_array_equal(vals[0], np.stack(rows)[:, HEADER_BYTES:])


def test_make_assembler_kinds():
    assert isinstance(make_assembler(4, 2, 4), NativeBlockAssembler)
    assert isinstance(make_assembler(4, 2, 4, prefer_native=False), BlockAssembler)


def test_stream_decode_matches_jax():
    """A lossy out-of-order stream of the small code's codewords -> the port's
    assembler -> the port's ``hybrid_decode`` and JAX's on the same drained
    arrays: equal ``failed``, equal values on the frames that did not fail,
    and those equal to the codewords."""
    jcode = small_jax_code()
    code = to_port_code(jcode)
    arrays = code_arrays(code, "cpu")
    w, nblocks = 1, 6
    src = random_words(np.random.default_rng(0), (nblocks, code.k, w))
    cw = to_words(encode_packed(arrays, to_torch(src)))  # (B, n, 1) uint32
    rng = np.random.default_rng(1)
    asm = BlockAssembler(code.n, code.k, 4, max_blocks=nblocks, decode_at_k=False)
    packets = [make_packet(0, b, s, cw[b, s].astype("<u4").tobytes())
               for b in range(nblocks) for s in range(code.n) if rng.random() >= 0.15]
    rng.shuffle(packets)
    _, nums, vals, erased = _drained(asm, packets)
    assert len(nums) == nblocks
    words = np.ascontiguousarray(vals).view("<u4").reshape(nblocks, code.n, w)

    v, _e, _it, failed = hybrid_decode(arrays, to_torch(words), torch.from_numpy(erased),
                                       peel_iters=50, emax=16)
    jv, _je, _jit, jfailed = jax_hybrid_decode(device_arrays(jcode), jnp.asarray(words),
                                               jnp.asarray(erased), peel_iters=50, emax=16)
    failed, jfailed = failed.numpy(), np.asarray(jfailed)
    np.testing.assert_array_equal(failed, jfailed)
    ok = ~failed
    assert ok.sum() >= nblocks - 1
    np.testing.assert_array_equal(to_words(v)[ok], np.asarray(jv)[ok])
    np.testing.assert_array_equal(to_words(v)[ok], cw[nums[ok]])
