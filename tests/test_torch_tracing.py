"""The port's spans and counters (``utils/profiling.py``) on the CPU: off by
default, the same outputs with recording on, the span tree of each entry,
the hybrid's counters against independent counts, and the spans' place in a
``torch.profiler`` trace (host ops inside the caller's ranges, never ranges
of their own)."""

import numpy as np
import pytest
import torch

from codec_bench import trace
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode, hybrid_decode_escalated
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.rs.code import rs_code
from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode_wide, rs_encode
from ldpc_erasure_codes_tpu_torch.utils import profiling
from torch_port_cases import random_words, to_torch

GE = ("ge.cube", "ge.elim", "ge.transforms", "ge.syndrome", "ge.apply")


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def ldpc():
    """A (64,32) toy code, B=8, W=2, PER .4: six frames keep a residual
    after the peel, one fits a one-frame sub-batch and five escalate, and
    every frame is recovered."""
    code = toy_code(64, 32, row_weight=8, seed=1)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(5)
    cw = encode_packed(arrays, to_torch(random_words(rng, (8, code.k, 2))))
    mask = torch.from_numpy(rng.random((8, code.n)) < 0.4)
    return arrays, cw, mask


@pytest.fixture(scope="module")
def rs():
    arrays = code_arrays(rs_code(255, 192), "cpu")
    rng = np.random.default_rng(7)
    cw = rs_encode(arrays, torch.from_numpy(rng.integers(0, 256, (4, 192, 8), dtype=np.uint8)))
    mask = torch.from_numpy(rng.random((4, 255)) < 0.2)
    mask[0, :70] = True  # one frame past n - k fails
    return arrays, cw.masked_fill(mask[:, :, None], 0), mask


ESCALATED = dict(peel_iters=10, impl="vmem", emax=128, ge_subbatch=1)


def _calls(rec: dict) -> dict:
    return {path: s["calls"] for path, s in rec["spans"].items()}


def test_off_by_default(ldpc, rs):
    arrays, cw, mask = ldpc
    assert not profiling.enabled()
    hybrid_decode_escalated(arrays, cw, mask, **ESCALATED)
    peel_decode(arrays, cw, mask, max_iters=5)
    encode_packed(arrays, cw[:, : arrays.n - arrays.m].contiguous())
    rs_decode_wide(*rs)
    assert profiling.snapshot() == {"calls": 0, "spans": {}, "counters": {}}


@pytest.mark.parametrize("kw", [ESCALATED, dict(ESCALATED, emax=16, ge_subbatch=0)],
                         ids=["compact", "whole"])
def test_hybrid_outputs_equal_with_recording(ldpc, kw):
    arrays, cw, mask = ldpc
    off = hybrid_decode_escalated(arrays, cw.clone(), mask, **kw)
    with profiling.recording():
        on = hybrid_decode_escalated(arrays, cw.clone(), mask, **kw)
    assert off[4] == on[4] > 0 and not off[3].all()
    for a, b in zip(off[:4], on[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rs_outputs_equal_with_recording(rs):
    off = rs_decode_wide(*rs)
    with profiling.recording():
        on = rs_decode_wide(*rs)
    assert off[2].any() and not off[2].all()
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hybrid_span_tree_and_counters(ldpc):
    """Two escalated calls through the production route (the compacted GE)
    and one that peels clean; the counters against counts made apart."""
    arrays, cw, mask = ldpc
    with profiling.recording():
        n_esc = sum(hybrid_decode_escalated(arrays, cw, mask, **ESCALATED)[4] for _ in range(2))
        clean = hybrid_decode_escalated(arrays, cw, torch.zeros_like(mask), **ESCALATED)
    rec = profiling.snapshot()
    assert clean[4] == 0 and n_esc > 0
    top, ge, esc = "hybrid.decode", "hybrid.decode/hybrid.ge.compact", "hybrid.decode/hybrid.escalate"
    want = {top: 3, f"{top}/hybrid.peel": 3, f"{top}/hybrid.peel/peel.decode": 3,
            f"{top}/hybrid.peel/peel.decode/peel.launch": 3, f"{top}/hybrid.sync.residual": 3,
            f"{top}/hybrid.sync.failed": 3, ge: 2, esc: 2,
            f"{esc}/hybrid.sync.candidates": 2, f"{esc}/hybrid.sync.emax": 2}
    want.update({f"{p}/{s}": 2 for p in (ge, esc) for s in ("ge.gather", *GE, "ge.scatter")})
    assert _calls(rec) == want
    assert rec["calls"] == 3
    assert all(s["stream_ms"] is None and s["host_s"] > 0 for s in rec["spans"].values())
    resid = peel_decode(arrays, cw, mask, max_iters=ESCALATED["peel_iters"])[1].any(dim=1)
    r = int(resid.sum())
    first = hybrid_decode(arrays, cw, mask, **ESCALATED)
    widest = int(first[1].sum(dim=1)[first[3]].max())
    assert rec["counters"] == {
        "hybrid.residual_frames": 2 * r,
        "hybrid.bucket_overflow_frames": 2 * max(0, r - ESCALATED["ge_subbatch"]),
        "hybrid.escalated_frames": n_esc,
        "hybrid.escalation_frames_padded": 2 * max(8, 1 << (n_esc // 2 - 1).bit_length()),
        "hybrid.escalation_emax": 2 * min(arrays.n, -(-widest // 128) * 128),
    }


def test_hybrid_routes_are_named(ldpc):
    """The first dispatch's span names its route; no escalation, no
    ``hybrid.escalate``."""
    arrays, cw, mask = ldpc
    with profiling.recording():
        hybrid_decode(arrays, cw, mask, peel_iters=10, impl="vmem", emax=128, ge_subbatch=2,
                      tiled=True, static_topo=True)
        hybrid_decode(arrays, cw, mask, peel_iters=10, impl="vmem", emax=128)
    paths = set(profiling.snapshot()["spans"])
    rows, whole = "hybrid.decode/hybrid.ge.rows", "hybrid.decode/hybrid.ge.whole"
    assert {f"{rows}/{s}" for s in ("ge.gather", *GE, "ge.scatter")} <= paths
    assert {f"{whole}/{s}" for s in GE} <= paths
    assert not any("escalate" in p or "sync.failed" in p or "ge.compact" in p for p in paths)


def test_rs_span_tree(rs):
    with profiling.recording():
        rs_decode_wide(*rs)
        rs_decode_wide(*rs)
    rec = profiling.snapshot()
    assert _calls(rec) == {"rs.decode": 2, **{f"rs.decode/{s}": 2 for s in GE}}
    assert rec["counters"] == {}


def test_peel_and_encode_span_trees(ldpc):
    arrays, cw, mask = ldpc
    with profiling.recording():
        peel_decode(arrays, cw, mask, max_iters=5)
        encode_packed(arrays, cw[:, : arrays.n - arrays.m].contiguous())
    assert _calls(profiling.snapshot()) == {
        "peel.decode": 1, "peel.decode/peel.launch": 1,
        "encode.packed": 1, "encode.packed/encode.launch": 1}


def test_count_sums_host_and_tensor_values():
    with profiling.recording():
        profiling.count("a", 3)
        profiling.count("a", torch.tensor(4))
        with profiling.span("top"):
            with profiling.span("child", x=1):
                pass
    profiling.count("a", 100)  # off: not counted
    rec = profiling.snapshot()
    assert rec["counters"] == {"a": 7}
    assert _calls(rec) == {"top": 1, "top/child": 1}
    profiling.reset()
    assert profiling.snapshot() == {"calls": 0, "spans": {}, "counters": {}}


def test_recording_follows_the_profiler(rs):
    assert not profiling.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.enabled()
        rs_decode_wide(*rs)
    assert not profiling.enabled()
    rs_decode_wide(*rs)
    assert profiling.snapshot()["spans"]["rs.decode"]["calls"] == 1


def _profile_hybrid(arrays, cw, mask):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function("hybrid"):
                hybrid_decode_escalated(arrays, cw, mask, **ESCALATED)
            with torch.profiler.record_function("codec.sync"):
                pass
    return prof.profiler.kineto_results.events()


def test_spans_are_host_ops_inside_the_callers_ranges(ldpc, monkeypatch):
    """The benchmark's trace reader sees the same ranges with the program's
    spans as without them; the spans are host ops, not user annotations."""
    arrays, cw, mask = ldpc
    events = _profile_hybrid(arrays, cw, mask)
    ours = [e for e in events if e.name().split(".")[0] in ("hybrid", "ge", "peel")
            and e.name() != "hybrid"]
    assert {"hybrid.decode", "hybrid.escalate", "ge.elim"} <= {e.name() for e in ours}
    assert not any(e.is_user_annotation() for e in ours)
    on = trace.summarize(events)
    monkeypatch.setattr(profiling, "span", lambda name, **kw: profiling._OFF)
    off = trace.summarize(_profile_hybrid(arrays, cw, mask))
    assert on.range_calls == off.range_calls == {"hybrid": 1, "codec.sync": 1}
