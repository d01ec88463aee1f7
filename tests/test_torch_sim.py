"""The port's channels, FER simulation and CLI against the JAX package.

Exact where both sides can be given the same inputs: the Gilbert-Elliott
chain on JAX's own uniforms, ``batch_stats`` on given masks, and the
driver's ``_decode`` / ``_decode_mask`` on given frames and masks. The
random draws differ between torch and JAX, so the channels' rates are
checked as statistics (tests/test_sim.py:101-131 is the template). The CLI
runs here with ``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import channel as jax_channel
from ldpc_erasure_codes_tpu import sim as jax_sim
from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.sim import driver as jax_driver
from ldpc_erasure_codes_tpu.sim.stats import batch_stats as jax_batch_stats
from ldpc_erasure_codes_tpu_torch import sim
from ldpc_erasure_codes_tpu_torch.channel import erasure as ch
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import (
    encode,
    encode_nb,
    encode_packed,
    random_bytes,
    random_words,
)
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_mask
from ldpc_erasure_codes_tpu_torch.sim import driver
from ldpc_erasure_codes_tpu_torch.utils import cli
from torch_port_cases import small_jax_code, to_port_code


@pytest.mark.parametrize("with_init", [False, True])
def test_gilbert_elliott_chain_on_jax_uniforms(with_init):
    key = jax.random.key(5)
    batch, n = 64, 300
    params = (0.05, 0.6, 0.2, 4.0)
    init = (np.arange(batch) % 2).astype(np.int32) if with_init else None
    jmask, jstate = jax_channel.gilbert_elliott_erasures(
        key, batch, n, jax_channel.GilbertElliottParams(*params),
        None if init is None else jnp.asarray(init))
    u = np.asarray(jax.random.uniform(key, (n, batch, 2)))  # the draw JAX made (:81)
    mask, state = ch.gilbert_elliott_chain(
        torch.from_numpy(u), ch.GilbertElliottParams(*params),
        None if init is None else torch.from_numpy(init))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert ch.gilbert_elliott_steady_state(ch.GilbertElliottParams(*params)) == pytest.approx(
        jax_channel.gilbert_elliott_steady_state(jax_channel.GilbertElliottParams(*params)))


@pytest.mark.parametrize("kind,per,expect", [
    ("iid", 0.14, 0.14),
    ("per64", 9 / 64, 9 / 64),
    ("gilbert_elliott", 0.0, ch.gilbert_elliott_steady_state(ch.GilbertElliottParams(0.01, 0.5))),
])
def test_channel_rates(kind, per, expect):
    code = get_code("n2040_k1530")
    cfg = sim.SimConfig(code=code.name, batch=64, track_values=False,
                        channel=sim.ChannelConfig(kind=kind),
                        decoder=sim.DecoderConfig(kind="peel"))
    step = sim.make_sim_step(code, cfg, device="cpu")
    arg = int(round(per * 64)) if kind == "per64" else per
    s = step(0, arg).to_host()
    assert s.frames == 64 and sum(s.iters_hist) == 64
    assert abs(s.erased_symbols / (64 * code.n) - expect) < 0.01
    assert s.rs_blocks == 64 * 8
    again = step(0, arg).to_host()
    assert again == s  # per-batch generators from (seed, call): repeatable


def test_batch_stats_match_jax():
    rng = np.random.default_rng(2)
    b, n, k = 16, 2040, 1530
    e_in = rng.random((b, n)) < 0.2
    e_out = e_in & (rng.random((b, n)) < 0.01)
    iters = rng.integers(0, 14, b).astype(np.int32)
    failed, ov = rng.random(b) < 0.3, rng.random(b) < 0.2
    for count_all in (False, True):
        want = jax_batch_stats(jnp.asarray(e_in), jnp.asarray(e_out), jnp.asarray(iters),
                               jnp.asarray(failed), k, 255, 192, 10, count_all, jnp.asarray(ov))
        got = sim.batch_stats(torch.from_numpy(e_in), torch.from_numpy(e_out),
                              torch.from_numpy(iters), torch.from_numpy(failed), k, 255, 192,
                              10, count_all, torch.from_numpy(ov)).to_host()
        for f, w in zip(got._fields, want):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(w), err_msg=f)
    acc = sim.Accumulator()
    acc.add(got)
    acc.add(got)
    assert acc.frames == 2 * b and acc.fer == got.block_errors / b


DECODERS = [
    dict(kind="peel"),
    dict(kind="peel", early_stop_k=True, impl="matmul"),
    dict(kind="hybrid", emax=12, peel_iters=2),
    dict(kind="hybrid", emax=12, ge_subbatch=3),
    dict(kind="ml", emax=14),
]


@pytest.mark.parametrize("dec", DECODERS, ids=lambda d: "-".join(f"{v}" for v in d.values()))
def test_driver_decode_matches_jax(dec):
    """The driver's value decode (scalar symbols) and pattern-only decode,
    on the same frames and masks: residual masks, iteration counts, failed
    and overflow flags, and the values of frames that did not fail."""
    jcode = small_jax_code()
    code = to_port_code(jcode)
    arrays, jarr = code_arrays(code, "cpu"), device_arrays(jcode)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 2, (16, code.k), dtype=np.uint8))
    cw = encode(arrays, src)
    mask = rng.random((16, code.n)) < 0.25
    recv = cw.masked_fill(torch.from_numpy(mask), 0)
    cfg = sim.SimConfig(batch=16, decoder=sim.DecoderConfig(**dec))
    jcfg = jax_sim.SimConfig(batch=16, decoder=jax_sim.DecoderConfig(**dec))
    got = driver._decode(arrays, cfg, recv, torch.from_numpy(mask), code.k)
    want = jax_driver._decode(jarr, jcfg, jnp.asarray(recv.numpy()), jnp.asarray(mask), code.k)
    ok = ~np.asarray(want[3]) if want[3] is not None else np.ones(16, bool)
    np.testing.assert_array_equal(got[0].numpy()[ok], np.asarray(want[0])[ok])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got_m = driver._decode_mask(arrays, cfg, torch.from_numpy(mask), code.k)
    want_m = jax_driver._decode_mask(jarr, jcfg, jnp.asarray(mask), code.k)
    for g, w in zip(got_m, want_m):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


NB_DECODERS = [
    dict(kind="peel"),
    dict(kind="peel", early_stop_k=True),
    dict(kind="hybrid", emax=14),
    dict(kind="hybrid", emax=14, ge_subbatch=3),
    dict(kind="ml", emax=16),
]


@pytest.mark.parametrize("wb", [0, 8])
@pytest.mark.parametrize("dec", NB_DECODERS, ids=lambda d: "-".join(f"{v}" for v in d.values()))
def test_driver_decode_gf256_matches_jax(dec, wb):
    """``sim/driver.py``'s GF(256) value decode on the small code lifted with seed
    0, scalar byte symbols (wb 0) and 8-byte symbols, PER .3: residual
    masks, iteration counts, failed and overflow flags, and the values of
    frames that did not fail, as JAX's ``_decode`` gives them."""
    jcode = small_jax_code().lift_to_gf256(seed=0)
    code = to_port_code(jcode)
    arrays, jarr = code_arrays(code, "cpu"), device_arrays(jcode)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 256, (16, code.k, wb)[: 3 if wb else 2],
                                        dtype=np.uint8))
    cw = encode_packed(arrays, src, gf_order=256) if wb else encode_nb(arrays, src)
    mask = rng.random((16, code.n)) < 0.3
    m = torch.from_numpy(mask)
    recv = cw.masked_fill(m[:, :, None] if wb else m, 0)
    cfg = sim.SimConfig(batch=16, gf_order=256, decoder=sim.DecoderConfig(**dec))
    jcfg = jax_sim.SimConfig(batch=16, gf_order=256, decoder=jax_sim.DecoderConfig(**dec))
    got = driver._decode(arrays, cfg, recv, m, code.k)
    want = jax_driver._decode(jarr, jcfg, jnp.asarray(recv.numpy()), jnp.asarray(mask), code.k)
    ok = ~np.asarray(want[3]) if want[3] is not None else np.ones(16, bool)
    assert ok.any() and np.asarray(want[1]).any()  # solved and stuck frames both occur
    np.testing.assert_array_equal(got[0].numpy()[ok], np.asarray(want[0])[ok])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hybrid_bucket_overflow_matches_jax():
    """The pattern-only hybrid of the JAX CLI's ``plot`` (50 sweeps, emax
    256, a bucket of B/8 frames) at (2040,1530), PER .1875, on one seeded
    4096-frame batch: the port's and the JAX package's ``_decode_mask``
    agree on every output, every failed frame is a column-bucket overflow
    (a residual of more than emax symbols), and at emax 512 the same frames
    are all solved, with no overflow. Both sides see the batch's residual
    frames after peeling; the other frames leave the peel decoded, on both
    sides (``peel_decode_mask`` equals JAX's, test_torch_peel_jacobi.py)."""
    code = get_code("n2040_k1530")
    arrays, jarr = code_arrays(code, "cpu"), device_arrays(jax_get_code(code.name))
    mask = np.random.default_rng(0).random((4096, code.n)) < 0.1875
    e, _ = peel_decode_mask(arrays, torch.from_numpy(mask), max_iters=50)
    frames = mask[e.any(dim=1).numpy()]
    for emax in (256, 512):
        dec = dict(kind="hybrid", max_iters=50, emax=emax, ge_subbatch=4096 // 8)
        cfg = sim.SimConfig(batch=len(frames), track_values=False,
                            decoder=sim.DecoderConfig(**dec))
        jcfg = jax_sim.SimConfig(batch=len(frames), track_values=False,
                                 decoder=jax_sim.DecoderConfig(**dec))
        got = driver._decode_mask(arrays, cfg, torch.from_numpy(frames), code.k)
        want = [np.asarray(w) for w in
                jax_driver._decode_mask(jarr, jcfg, jnp.asarray(frames), code.k)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        failed, overflow = want[2], want[3]
        print(f"emax {emax}: {len(frames)} frames, JAX failed {int(failed.sum())}, "
              f"overflowed {int(overflow.sum())}")
        if emax == 256:
            assert (len(frames), int(failed.sum())) == (79, 27)
            np.testing.assert_array_equal(failed, overflow)
            frames = frames[failed]
        else:
            assert not failed.any() and not overflow.any()


def test_sim_cli_smoke(capsys):
    """``sim`` prints the JAX CLI's report, then its JSON lines."""
    argv = ["sim", "--code", "n2000_k1000", "--batch", "8", "--symbol-words", "2",
            "--pers", "0.3,0.45", "--target-errors", "1", "--max-frames", "16",
            "--steps-per-call", "1", "--tiled-pipeline", "--json", "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    args = cli.parser().parse_args(argv)
    want = jax_sim.format_report(args.code, jax_sim.SimConfig(
        code=args.code, batch=8, symbol_words=2, tiled_pipeline=True,
        decoder=jax_sim.DecoderConfig(impl="vmem")), []).splitlines()
    assert lines[:2] == want
    points = [json.loads(x) for x in lines[4:]]
    assert [p["per"] for p in points] == [0.3, 0.45]
    assert set(points[0]) >= set(jax_sim.FERPoint.__dataclass_fields__)
    assert points[1]["frames"] >= 8 and 0.4 < points[1]["measured_per"] < 0.5


@pytest.mark.parametrize("schedule,impl", [("counted", "pallas"), ("jacobi", "pallas"),
                                           ("seq", "xla")])
def test_throughput_cli_smoke(capsys, schedule, impl):
    rc = cli.main(["throughput", "--code", "n2000_k1000", "--batch", "4", "--symbol-words",
                   "2", "--per", "0.2", "--reps", "2", "--schedule", schedule, "--impl", impl,
                   "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"code", "per", "frames_per_sec", "info_gbps", "symbol_bits"}
    # info_gbps is rounded to 3 decimals, as the JAX CLI prints it, so a
    # slow CPU run may print 0.0; frames_per_sec carries the measurement.
    assert out["frames_per_sec"] > 0 and out["symbol_bits"] == 64
    assert abs(out["info_gbps"] - out["frames_per_sec"] * 1000 * 64 / 1e9) <= 1e-3


def test_throughput_step_consumes_values():
    """tests/test_cli.py::test_throughput_step_consumes_values: two codeword
    batches under the same channel draw give different digests."""
    code = get_code("n2000_k1000")
    arrays = code_arrays(code, "cpu")
    step = cli.make_throughput_step(code, arrays, batch=4, per=0.2, max_iters=50,
                                    schedule="grouped")
    g = torch.Generator().manual_seed(1)
    cw1 = encode_packed(arrays, random_words((4, code.k, 2), g, "cpu"))
    cw2 = encode_packed(arrays, random_words((4, code.k, 2), g, "cpu"))
    d1 = step(torch.Generator().manual_seed(7), cw1)
    d2 = step(torch.Generator().manual_seed(7), cw2)
    assert int(d1[0]) == int(d2[0]) and not torch.equal(d1[1], d2[1])


@pytest.mark.parametrize("draw", ["words", "bytes"])
@pytest.mark.parametrize("shape", [(3, 8), (4, 1530, 4), (2, 5, 1024)])
def test_source_draws_are_one_randint(draw, shape):
    """The source draws of the value-tracking sim, the battery, ``cli
    throughput`` and the stream demo are one ``torch.randint`` of int32
    words over all 32 bits (bytes: W/4 words viewed as uint8), so a seeded
    generator gives the same stream and leaves the same state."""
    g, want_g = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    words = (*shape[:-1], shape[-1] // 4) if draw == "bytes" else shape
    want = torch.randint(-(2**31), 2**31, words, dtype=torch.int32, generator=want_g)
    if draw == "bytes":
        got = random_bytes(shape, g, "cpu")
        want = want.view(torch.uint8)
    else:
        got = random_words(shape, g, "cpu")
    assert got.dtype == want.dtype and got.shape == shape and torch.equal(got, want)
    assert torch.equal(torch.randint(0, 2**31, (4,), generator=g),
                       torch.randint(0, 2**31, (4,), generator=want_g))


def test_cli_defaults_to_the_card():
    args = cli.parser().parse_args(["sim"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.resolve_device(args.device)


def test_codes_cli_matches_jax(capsys):
    """``codes`` lists the shipped codes in the JAX CLI's format."""
    from ldpc_erasure_codes_tpu.utils import cli as jax_cli

    assert cli.main(["codes"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["codes"]) == 0
    assert got == capsys.readouterr().out and got.count("\n") >= 3


def test_sim_step_vmem_schedule_maps_as_jax(monkeypatch):
    """``DecoderConfig(impl="vmem", schedule="jacobi")`` on packed symbols:
    the JAX driver runs its sequential Pallas peel (interpret mode) for
    every schedule but "unrolled", and so does the port's. One batch of the
    toy code through both sim steps, on the same NumPy-made source and
    mask, gives equal ``SimStats``, the iteration sum included; the Jacobi
    schedule itself would report other counts on this batch."""
    from ldpc_erasure_codes_tpu.codes.toy import toy_code as jax_toy_code
    from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
    from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode

    b, w, per = 16, 2, 0.2
    code, jcode = toy_code(64, 32, row_weight=4), jax_toy_code(64, 32, row_weight=4)
    rng = np.random.default_rng(21)
    src = rng.integers(0, 2**32, (b, code.k, w), dtype=np.uint32)
    mask = rng.random((b, code.n)) < per
    dec = dict(kind="peel", impl="vmem", schedule="jacobi", max_iters=50)
    cfg = sim.SimConfig(batch=b, symbol_words=w, decoder=sim.DecoderConfig(**dec))
    jcfg = jax_sim.SimConfig(batch=b, symbol_words=w, decoder=jax_sim.DecoderConfig(**dec))
    monkeypatch.setattr(driver, "_draw_source",
                        lambda gen, c, k, device: torch.from_numpy(src.view(np.int32)))
    monkeypatch.setattr(driver, "_erasure_mask",
                        lambda gen, c, n, p, device: torch.from_numpy(mask))
    monkeypatch.setattr(jax_driver, "_draw_source", lambda key, c, k: jnp.asarray(src))
    monkeypatch.setattr(jax_driver, "_erasure_mask", lambda key, c, n, p: jnp.asarray(mask))
    got = sim.make_sim_step(code, cfg, device="cpu")(0, per).to_host()
    want = jax_driver.make_sim_step(jcode, jcfg)(jax.random.key(0), jnp.float32(per))
    for f, wv in zip(got._fields, want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(wv), err_msg=f)
    assert got.frames == b and sum(got.iters_hist) == b
    arrays = code_arrays(code, "cpu")
    cw = driver._encode(arrays, cfg, torch.from_numpy(src.view(np.int32)))
    erased = torch.from_numpy(mask)
    seq_iters = peel_decode(arrays, cw, erased, max_iters=50)[2]
    jacobi_iters = peel_decode(arrays, cw, erased, max_iters=50, schedule="jacobi")[2]
    assert sum(i * c for i, c in enumerate(got.iters_hist)) == int(seq_iters.sum())
    assert int(seq_iters.sum()) != int(jacobi_iters.sum())
