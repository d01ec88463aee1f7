"""The port's chunked RS stream driver (``rs/stream.py``) on the CPU.

A tiny stream (B = 8 frames, 16-byte payloads, e = 8, three chunks) runs
end to end; each chunk ``c ⊗ cw0`` is held to ``gf_mul_np`` on the host and
its decode to JAX's ``rs_decode_wide`` on the same received bytes and mask
(``c`` is passed in explicitly: the two packages' generators differ); the
digest is JAX's reduction; the expected-digest check catches one flipped
byte, and the frame check catches a decode fault that repeats an even
number of times at one byte position, which the digest cancels. The
driver reads its sizes from JAX's environment names. The host-io leg
needs pinned memory and a CUDA stream, so here it must raise
(``tests/test_torch_cuda.py`` runs it on the card). The host syncs' sites
are read from the Python stack: the innermost frame of the port.
"""

import json
import linecache
import os
import traceback
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import rs as jrs
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu_torch.gf import gf_mul_np
from ldpc_erasure_codes_tpu_torch.rs import stream
from ldpc_erasure_codes_tpu_torch.rs.stream import RSStream, chunk_scalar, run_stream

TINY = dict(b=8, wb=16, e=8)


@pytest.fixture(scope="module")
def tiny():
    return RSStream(device=torch.device("cpu"), **TINY)


@pytest.fixture
def tiny_env(monkeypatch):
    """The driver's sizes set to TINY through JAX's environment names."""
    for k, v in (("RS_BATCH", "8"), ("RS_WB", "16"), ("RS_E", "8")):
        monkeypatch.setenv(k, v)


def test_run_stream_quick_on_cpu(tiny_env):
    out = run_stream(quick=True, device="cpu", chunks=3, log=lambda _m: None)
    assert (out["chunks"], out["mismatches"], out["frame_mismatches"], out["bad"]) == (3, 0, 0, 0)
    assert out["chunk_bytes"] == 8 * 255 * 16 and out["stream_bytes"] == 3 * out["chunk_bytes"]
    assert out["syncs_per_chunk"] is None and out["sync_sites"] is None
    assert out["host_io"] is None
    assert out["sustained_gbps"] > 0 and out["single_gbps"] > 0


def test_erasure_mask_is_jax_draw():
    want = np.zeros((8, 255), dtype=bool)
    rng = np.random.default_rng(8)
    for i in range(8):
        want[i, rng.choice(192, size=8, replace=False)] = True
    np.testing.assert_array_equal(stream.erasure_mask(8, 8), want)


def test_xor_digest_matches_numpy():
    for frames in (1, 3, 8):
        v = np.random.default_rng(frames).integers(0, 256, (frames, 255, 16), dtype=np.uint8)
        want = np.bitwise_xor.reduce(np.bitwise_xor.reduce(v.astype(np.uint32), axis=1), axis=0)
        np.testing.assert_array_equal(stream.xor_digest(torch.from_numpy(v)).numpy(), want)


@pytest.mark.parametrize("i", range(3))
def test_chunk_decode_matches_jax(tiny, i):
    c = chunk_scalar(i, tiny.device)
    assert 1 <= int(c) <= 255
    cw0 = tiny.cw0.numpy()
    cw = tiny.scaled(c)
    np.testing.assert_array_equal(cw.numpy(), gf_mul_np(cw0, int(c)))
    mask = tiny.mask.numpy()
    recv = np.where(mask[:, :, None], 0, cw.numpy()).astype(np.uint8)
    before = tiny.read()
    v = tiny.decode(cw, c)
    jv, je, jf = jrs.rs_decode_wide(device_arrays(jrs.rs_code(255, 192)), jnp.asarray(recv),
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(v.numpy(), cw.numpy())
    assert not np.asarray(jf).any() and not np.asarray(je).any()
    assert tiny.read() == before
    jdigest = np.bitwise_xor.reduce(
        np.bitwise_xor.reduce(np.asarray(jv).astype(np.uint32), axis=1), axis=0)
    np.testing.assert_array_equal(stream.xor_digest(v).numpy(), jdigest)
    np.testing.assert_array_equal(jdigest, gf_mul_np(stream.xor_digest(tiny.cw0).numpy(),
                                                     int(c)))


def test_digest_check_catches_one_flipped_byte(tiny):
    c = chunk_scalar(5, tiny.device)
    cw = tiny.scaled(c).clone()
    frame, sym = 3, int(np.nonzero(~tiny.mask[3].numpy())[0][0])  # a received symbol
    cw[frame, sym, 7] ^= 0x10
    before = tiny.read()
    tiny.decode(cw, c)
    after = tiny.read()
    assert (after[0], after[2]) == (before[0] + 1, before[2])


@pytest.mark.parametrize("frames", [slice(None), [5, 6]], ids=["every_frame", "two_frames"])
def test_frame_check_catches_what_the_digest_cancels(monkeypatch, frames):
    """A decode fault at one byte position in an even number of frames
    leaves the digest equal; over B / CHECK_FRAMES chunks the frame check
    holds every frame and finds it."""
    s = RSStream(device=torch.device("cpu"), **TINY)
    decode = stream.rs_decode_wide

    def faulty(arrays, recv, mask):
        v, e, f = decode(arrays, recv, mask)
        v = v.clone()
        v[frames, 0, 3] ^= 0x5A
        return v, e, f

    monkeypatch.setattr(stream, "rs_decode_wide", faulty)
    for i in range(TINY["b"] // stream.CHECK_FRAMES):
        s.chunk(chunk_scalar(i, s.device))
    digest, frame, bad = s.read()
    assert (digest, bad) == (0, 0)
    assert frame == (TINY["b"] if frames == slice(None) else 2)


def test_host_io_raises_on_cpu(tiny, tiny_env):
    with pytest.raises(ValueError, match="CUDA"):
        run_stream(quick=True, host_io=True, device="cpu", chunks=2)
    with pytest.raises(ValueError, match="needs"):
        stream.host_io_leg(tiny, 2)


def test_sizing_needs_a_card_or_a_count(monkeypatch, tiny_env):
    with pytest.raises(ValueError, match="chunks="):
        run_stream(quick=True, device="cpu", log=lambda _m: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_stream(quick=True, chunks=2)


def test_settings_read_jax_names(monkeypatch):
    assert stream.settings(False) == {"b": 2048, "wb": 1024, "e": 32, "stream_x": 4.0}
    assert stream.settings(True)["b"] == 256 and stream.settings(True)["stream_x"] == 0.05
    for k, v in (("RS_BATCH", "8"), ("RS_WB", "16"), ("RS_E", "8"), ("STREAM_X", "2")):
        monkeypatch.setenv(k, v)
    assert stream.settings(True) == {"b": 8, "wb": 16, "e": 8, "stream_x": 2.0}


def test_module_entry_point(monkeypatch, capsys):
    for k, v in (("RS_BATCH", "8"), ("RS_WB", "16"), ("RS_E", "8")):
        monkeypatch.setenv(k, v)
    assert stream.main(["--quick", "--device", "cpu", "--chunks", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["b"], out["chunks"], out["mismatches"], out["frame_mismatches"],
            out["bad"]) == (8, 2, 0, 0, 0)


def test_trace_of_one_chunk(tmp_path, tiny_env):
    out = run_stream(quick=True, device="cpu", chunks=2, trace_dir=str(tmp_path),
                     log=lambda _m: None)
    assert (out["b"], out["mismatches"], out["frame_mismatches"], out["bad"]) == (8, 0, 0, 0)
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_port_site_is_the_innermost_frame_of_the_port():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(stream.__file__)))
    frame = traceback.FrameSummary
    stack = [frame("/x/runner.py", 3, "main"),
             frame(os.path.join(pkg, "rs", "stream.py"), 40, "chunk"),
             frame(os.path.join(pkg, "ops", "elim.py"), 330, "launch"),
             frame("/x/torch/functional.py", 9, "unique")]
    assert stream.port_site(stack, "Sync.cpp", 1) == "ldpc_erasure_codes_tpu_torch/ops/elim.py:330"
    assert stream.port_site(stack[:1], "Sync.cpp", 1) == "Sync.cpp:1"


def test_sync_sites_name_the_port_lines(tiny_env):
    """Sync warnings raised from inside ``run_stream`` (through its ``log``)
    are placed on the lines of ``rs/stream.py`` that call ``log``; other
    warnings, torch's notice on switching the mode on among them, are not
    counted, and the hook is gone afterwards."""
    calls = []

    def log(msg):
        calls.append(msg)
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("Synchronization debug mode is a prototype feature and does not yet "
                      "detect all synchronizing operations")
        warnings.warn("an unrelated warning")

    shown = warnings.showwarning
    with stream.sync_sites() as sites:
        run_stream(quick=True, device="cpu", chunks=3, log=log)
    assert warnings.showwarning is shown
    assert len(sites) == len(calls) >= 3
    for site in sites:
        path, line = site.rsplit(":", 1)
        assert path == "ldpc_erasure_codes_tpu_torch/rs/stream.py", site
        assert "log(" in linecache.getline(stream.__file__, int(line)), site
