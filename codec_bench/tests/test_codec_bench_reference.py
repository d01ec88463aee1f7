"""The reference against the program's CPU path, and the frozen inputs.

The reference must agree with the program where the program is right: the
same codewords from the same source, and the same frames recovered. It must
also hold on inputs of its own: the frozen code file, the GF(256) tables, the
traffic draws and the rooflines' byte counts.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from conftest import BENCH, REPO

from codec_bench import digest, harness, port, traffic
from codec_bench.reference import codes, recovery
from codec_bench.reference import sim as ref_sim

LDPC = json.load(open(os.path.join(BENCH, "configs", "ldpc2040_k1530_s8192.json")))
RS = json.load(open(os.path.join(BENCH, "configs", "rs255_k192_s8192.json")))
CPU = torch.device("cpu")


def words(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=g)


@pytest.mark.parametrize("config", [LDPC, RS], ids=["ldpc", "rs"])
@pytest.mark.parametrize("w", [1, 4])
def test_encoders_agree(config, w):
    arrays = port.code_arrays(config, CPU)
    ref = codes.load(config["code"], BENCH)
    src = words((5, config["code"]["k"], w), 3 + w)
    assert torch.equal(ref.codewords(src), port.encode(config, arrays, src))


def test_encoder_blocks():
    ref = codes.load(LDPC["code"], BENCH)
    src = words((5, 1530, 2), 9)
    assert torch.equal(ref.codewords(src, block_bytes=1), ref.codewords(src))


def test_ldpc_codewords_satisfy_h():
    ref = codes.load(LDPC["code"], BENCH)
    cw = ref.codewords(words((3, 1530, 2), 1))
    h = torch.from_numpy(ref.h).to(torch.int64)
    bits = (cw[..., None] >> torch.arange(32)) & 1  # (F, n, W, 32)
    assert not torch.any((torch.einsum("mn,fnwb->fmwb", h, bits.to(torch.int64)) % 2).bool())


@pytest.mark.parametrize("per", [0.1406, 0.2031, 0.26])
def test_peel_closure_matches_the_peel(per):
    """The fixed point equals the program's peel run to convergence."""
    from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode

    arrays = port.code_arrays(LDPC, CPU)
    ref = codes.load(LDPC["code"], BENCH)
    mask = traffic.loss({"model": "iid", "per": per}, 5, 0, 1, (12, 2040), CPU)
    _, erased, _ = peel_decode(arrays, torch.zeros((12, 2040, 1), dtype=torch.int32), mask,
                               max_iters=2040)
    assert torch.equal(recovery.peel_closure(ref, mask), erased)


@pytest.mark.parametrize("per", [0.2031, 0.25, 0.27])
def test_ml_rank_matches_the_programs_rank_check(per):
    from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check

    arrays = port.code_arrays(LDPC, CPU)
    ref = codes.load(LDPC["code"], BENCH)
    mask = traffic.loss({"model": "iid", "per": per}, 6, 0, 1, (24, 2040), CPU)
    ok = recovery.ml_rank(ref, mask)
    assert torch.equal(ok, ~ge_rank_check(arrays, mask, emax=2040))
    if per == 0.27:
        assert 0 < int(ok.sum()) < 24


def test_mds_and_decode_agree_with_rs():
    from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode_wide

    arrays = port.code_arrays(RS, CPU)
    ref = codes.load(RS["code"], BENCH)
    src = words((6, 192, 2), 4)
    cw = ref.codewords(src)
    lost = torch.zeros((6, 255), dtype=torch.bool)
    for f, e in enumerate((0, 1, 40, 63, 64, 90)):
        lost[f, torch.randperm(255, generator=torch.Generator().manual_seed(f))[:e]] = True
    values, erased, failed = rs_decode_wide(
        arrays, cw.masked_fill(lost[:, :, None], 0).view(torch.uint8), lost)
    assert torch.equal(~failed, recovery.mds(ref, lost))
    ok = ~failed
    assert torch.equal(values.view(torch.int32)[ok], cw[ok]) and not erased[ok].any()


def test_frozen_code_file():
    path = os.path.join(BENCH, LDPC["code"]["file"])
    assert port.sha256(path) == LDPC["code"]["sha256"]
    assert port.sha256(os.path.join(REPO, LDPC["code"]["port_file"])) == LDPC["code"]["sha256"]
    port.check_code_files(LDPC, BENCH, REPO)


def test_frozen_code_file_refused_when_changed(tmp_path):
    cfg = json.loads(json.dumps(LDPC))
    cfg["code"]["sha256"] = "0" * 64
    with pytest.raises(ValueError, match="sha256"):
        port.check_code_files(cfg, BENCH, REPO)


def test_gf256_tables():
    gf = codes.GF256.frozen()
    assert gf.poly == 0x171 and len(set(gf.exp.tolist())) == 255
    a = np.arange(1, 256)
    assert np.all(gf.mul(a, gf.inv(a)) == 1)
    from ldpc_erasure_codes_tpu_torch.gf.tables import build_tables

    assert np.array_equal(gf.mul(a[:, None], a[None, :]), build_tables().mul[1:, 1:])


def test_traffic_draws():
    a = traffic.source(2**31 + 99, 3, (2, 5, 4), CPU)
    assert torch.equal(a, traffic.source(2**31 + 99, 3, (2, 5, 4), CPU))
    assert not torch.equal(a, traffic.source(2**31 + 99, 4, (2, 5, 4), CPU))
    m = traffic.loss({"model": "iid", "per": 0.1875}, 2**32 + 5, 0, 1, (400, 2040), CPU)
    assert abs(float(m.float().mean()) - 0.1875) < 0.003
    ge = {"model": "gilbert_elliott", "alpha": 0.05, "beta": 0.6, "transition": 0.1, "bias": 10.0}
    m = traffic.loss(ge, 1, 0, 1, (200, 2040), CPU)
    steady = (10 / 11) * 0.05 + (1 / 11) * 0.6  # time in Bad: (1/bias) / (1 + 1/bias)
    assert abs(float(m.float().mean()) - steady) < 0.01
    runs = (m[:, 1:] & m[:, :-1]).float().mean() / m.float().mean()
    assert float(runs) > 0.25  # losses come in bursts


def test_fixed_losses_are_reordered_by_the_seed():
    spec = {"model": "iid", "per": 0.2, "seed": 77}
    a = [traffic.loss(spec, 1, j, 5, (3, 40), CPU) for j in range(5)]
    b = [traffic.loss(spec, 2**31 + 1, j, 5, (3, 40), CPU) for j in range(5)]
    assert sorted(x.flatten().tolist() for x in a) == sorted(x.flatten().tolist() for x in b)
    assert [x.flatten().tolist() for x in a] != [x.flatten().tolist() for x in b]


def test_sample_slots_cover_every_frame():
    s = traffic.sample_slots(11, 2, 64, 16)
    assert s.shape == (4, 16) and sorted(s.reshape(-1).tolist()) == list(range(64))


def test_digest_sees_one_bit():
    x = words((3, 7, 4), 2)
    mult = digest.multipliers(7, 4, CPU)
    for bit in (0, 17, 31):
        y = x.clone()
        y[1, 5, 2] ^= 1 << bit if bit < 31 else -(2**31)
        d = digest.frames(x, mult) != digest.frames(y, mult)
        assert d.tolist() == [False, True, False]
    known = torch.ones((3, 7), dtype=torch.bool)
    known[1, 5] = False
    assert torch.equal(digest.frames(x, mult, known), digest.frames(y, mult, known))


class _Trace:
    window_s, busy_s = 2.0, 1.5
    range_device_s = {"peel": 0.5, "encode": 0.5, "sim": 4.0}
    range_calls = {"peel": 100, "encode": 100, "sim": 16}


@pytest.mark.parametrize("metric, layer, expect", [
    ("peel_roofline", "peel",
     100 * 100 * (2048 * 2040 * 1024 * 2 + 2048 * 2040 * 2 + 2048 * 4) / 3.35e12 / 0.5),
    ("encode_roofline", "encode", 100 * 100 * 2048 * (1530 + 2040) * 1024 / 3.35e12 / 0.5),
    ("device.idle_pct", "peel", 25.0),
])
def test_roofline_byte_counts(metric, layer, expect):
    readers = harness.metric_readers(BENCH)
    view = harness.RunView(layer, 2048, 2040, 1530, 256, "NVIDIA H100 80GB HBM3", _Trace(), None)
    assert readers[metric].read(view) == pytest.approx(expect)
    other = harness.RunView("rs", 2048, 2040, 1530, 256, "NVIDIA H100 80GB HBM3", _Trace(), None)
    if metric != "device.idle_pct":
        assert readers[metric].read(other) is None


SIM = json.load(open(os.path.join(BENCH, "traffic", "sim_peel.per1875.json")))


def sim_traffic(**changes) -> dict:
    t = json.loads(json.dumps(SIM))
    decoder = {k: changes.pop(k) for k in ("max_iters", "early_stop_k") if k in changes}
    t["decoder"].update(decoder)
    t["loss"]["per"] = changes.pop("per", t["loss"]["per"])
    t.update(changes)
    return t


def program_sim_step(t: dict, seed: int):
    from ldpc_erasure_codes_tpu_torch import sim

    cfg = sim.SimConfig(code=LDPC["code"]["port_name"], batch=t["batch"], symbol_words=1,
                        channel=sim.ChannelConfig(kind="iid", per=t["loss"]["per"]),
                        decoder=sim.DecoderConfig(kind="peel", max_iters=t["decoder"]["max_iters"],
                                                  early_stop_k=t["decoder"]["early_stop_k"]),
                        seed=seed, track_values=False, steps_per_call=t["steps_per_call"])
    return cfg, sim.make_sim_step(cfg.code, cfg, device="cpu")


@pytest.mark.parametrize("seed, call, j", [(0, 0, 0), (2**31 + 12345, 3, 1), (2**33 + 7, 0xFFFFFFF, 15)])
def test_sim_draw_is_the_steps(seed, call, j):
    """The reference's copy of the step's draw: the batch's generator seed
    and its i.i.d. mask."""
    from ldpc_erasure_codes_tpu_torch.sim import driver

    t = sim_traffic(batch=16)
    cfg, _ = program_sim_step(t, seed)
    want = driver._erasure_mask(driver.batch_generator(seed, call, j, CPU), cfg, 2040, 0.1875, CPU)
    assert torch.equal(ref_sim.losses(seed, call, j, (16, 2040), 0.1875, CPU), want)
    assert ref_sim.batch_seed(seed, call, j) == driver.batch_generator(seed, call, j, CPU).initial_seed()


@pytest.mark.parametrize("changes", [
    {},  # the cell's point: most batches run every sweep
    {"per": 0.05},  # every frame clears its first k: the batch stops early
    {"per": 0.3},  # stalls: the batch stops when a sweep resolves nothing
    {"max_iters": 5},  # the cap cuts the peel short
    {"early_stop_k": False, "per": 0.15},  # the stop waits for all n
], ids=["per1875", "per05", "per30", "cap5", "all_n"])
def test_sim_counters_match_the_step(changes):
    """Every counter of the program's step, the histogram included, equals
    the reference's for the same seed and call."""
    t = sim_traffic(batch=24, steps_per_call=2, **changes)
    seed = 2**31 + 99
    _, step = program_sim_step(t, seed)
    ref = ref_sim.Campaign(t, LDPC, BENCH, CPU)
    for call in (0, 1):
        got = step(call, t["loss"]["per"])
        flat = torch.cat([x.reshape(-1).to(torch.int64) for x in got]).numpy()
        assert np.array_equal(ref.counters(seed, call), flat), call
        assert len(got.iters_hist) == t["decoder"]["max_iters"] + 1


def test_sim_check_counts_visits_and_unrun_calls():
    cell = harness.Cell.load(BENCH, "sim.table1_peel")
    cell.traffic.update(batch=8, steps_per_call=1, pool_calls=3)
    ref = ref_sim.Campaign(cell.traffic, cell.config, BENCH, CPU)
    good = [ref.counters(5, j) for j in range(3)]
    bad = good[1].copy()
    bad[-1] += 1
    checks, total = harness.sim_check(cell, BENCH, 5, [[good[0]], [good[1], bad, good[1]], []], CPU)
    assert checks == {"stats_mismatch": 1, "batches_unchecked": 1}
    assert np.array_equal(total, sum(good))


def test_sim_readers():
    readers = harness.metric_readers(BENCH)
    view = harness.RunView("sim", 4096, 2040, 1530, 256, "NVIDIA H100 80GB HBM3", _Trace(), 1617.25)
    assert readers["sim.device_ms"].read(view) == pytest.approx(250.0)
    assert readers["sim.syncs_per_call"].read(view) == 1617.25
    other = harness.RunView("hybrid", 1024, 2040, 1530, 256, "NVIDIA H100 80GB HBM3", _Trace(), 4.0)
    assert readers["sim.device_ms"].read(other) is None
    assert readers["sim.syncs_per_call"].read(other) is None
    assert readers["hybrid.syncs_per_batch"].read(view) is None
