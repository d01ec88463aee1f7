"""The port's PASSED/FAILED battery (``utils/verify.py::run_battery``) and
``cli verify``, on the CPU.

tests/test_verify_battery.py is the template: the quick battery returns
JAX's five tiers in order, each PASSED, and the hybrid tier had GE work.
The two packages draw their inputs from different generators, so the
records of two batteries are not compared; instead the same frames, made
with NumPy from a seed, go through JAX's peel (interpret mode) and its
``_check_peel`` and through the port's peel and tier check, with equal
counts, and one flipped word fails both.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes.registry import LDPCCode as JaxCode
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem, static_topology
from ldpc_erasure_codes_tpu.utils.verify import _check_peel as jax_check_peel
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.utils import cli, verify
from torch_port_cases import random_words, to_torch, to_words

# The record keys of JAX's tiers (ldpc_erasure_codes_tpu/utils/verify.py
# :111-119, :212-220, :289-297, :341-347), after tier, status, elapsed_s.
PEEL_KEYS = ("frames", "value_mismatches", "erased_nonzero", "oracle_mask_mismatches",
             "oracle_iter_mismatches")
JAX_KEYS = {
    "binary_unrolled": PEEL_KEYS,
    "binary_seq": PEEL_KEYS,
    "nb_unrolled": PEEL_KEYS,
    "hybrid_ge": ("frames", "ge_frames", "failed_frames", "value_mismatches",
                  "residual_on_solved"),
    "rs_wide": ("frames", "erasures", "value_mismatches", "failure_flag_mismatches"),
}


@pytest.fixture(scope="module")
def battery():
    return verify.run_battery(device="cpu", quick=True)


def test_battery_quick_all_passed(battery):
    assert [r["tier"] for r in battery] == list(verify.TIERS) == list(JAX_KEYS)
    for r in battery:
        assert r["status"] == "PASSED", r
    hy = battery[verify.TIERS.index("hybrid_ge")]
    assert hy["ge_frames"] > 0


@pytest.mark.parametrize("tier", list(JAX_KEYS))
def test_tier_record_has_jax_keys(battery, tier):
    (r,) = [r for r in battery if r["tier"] == tier]
    assert list(r)[:3] == ["tier", "status", "elapsed_s"]
    assert set(JAX_KEYS[tier]) <= set(r), sorted(r)
    assert "_ok" not in r and "ok" not in r


def test_rs_pattern_is_jax_draw():
    """The RS tier's erasures are JAX's own draw (verify.py:322-331)."""
    mask = verify.rs_battery_mask(64, 255)
    rng = np.random.default_rng(5)
    for f in range(64):
        e = 1 + round((62 and f * 62 / 62) or 0) if f < 63 else 64
        want = np.zeros(255, bool)
        want[rng.choice(255, e, replace=False)] = True
        np.testing.assert_array_equal(mask[f], want)
    assert mask[:63].sum(axis=1).max() == 63 and mask[63].sum() == 64


def _both_sides(schedule: str):
    """The same NumPy frames through JAX's interpret-mode peel and the
    port's peel: (JAX code, port arrays, codewords, mask, JAX outputs, port
    outputs), outputs as NumPy."""
    port_code = verify._small_code()
    jcode = JaxCode(port_code.name, port_code.n, port_code.k, port_code.vlist_idx,
                    port_code.vlist_len, port_code.vlist_val)
    arrays = code_arrays(port_code, "cpu")
    rng = np.random.default_rng(14)
    cw = to_words(encode_packed(arrays, to_torch(random_words(rng, (16, port_code.k, 2)))))
    mask = rng.random((16, port_code.n)) < 0.25
    jarrays = device_arrays(jcode)
    kw = dict(static_topo=static_topology(jarrays)) if schedule == "unrolled" else {}
    recv = np.where(mask[:, :, None], 0, cw)
    jout = peel_decode_vmem(jarrays, jnp.asarray(recv), jnp.asarray(mask), max_iters=50,
                            b_tile=8, schedule=schedule, interpret=True, **kw)
    pv, pe, pi = peel_decode(arrays, to_torch(recv), torch.from_numpy(mask), max_iters=50,
                             schedule=schedule)
    return jcode, arrays, cw, mask, [np.asarray(x) for x in jout], (to_words(pv), pe, pi)


def _port_check(arrays, cw, mask, v, e, it):
    return verify.check_peel_tier(arrays, to_torch(cw), torch.from_numpy(mask),
                                  to_torch(v), e, it)


@pytest.mark.parametrize("schedule", ["unrolled", "seq"])
def test_peel_tier_check_matches_jax(schedule):
    jcode, arrays, cw, mask, (jv, je, ji), (pv, pe, pi) = _both_sides(schedule)
    want = jax_check_peel(jcode, cw, mask, jv, je, ji, 50)
    got = _port_check(arrays, cw, mask, pv, pe, pi)
    assert want["_ok"] and got["_ok"]
    assert {k: got[k] for k in PEEL_KEYS} == {k: want[k] for k in PEEL_KEYS}
    # One decoded word flipped at the same resolved slot: both fail alike.
    f, s = (int(x[0]) for x in np.nonzero(~je))
    jv, pv = jv.copy(), pv.copy()
    jv[f, s, 1] ^= 1 << 31
    pv[f, s, 1] ^= 1 << 31
    want = jax_check_peel(jcode, cw, mask, jv, je, ji, 50)
    got = _port_check(arrays, cw, mask, pv, pe, pi)
    assert want["value_mismatches"] == got["value_mismatches"] == 1
    assert not want["_ok"] and not got["_ok"]
    assert verify._tier("binary", lambda: dict(got))["status"] == "FAILED"


def test_crashing_tier_is_failed():
    r = verify._tier("boom", lambda: 1 // 0)
    assert (r["tier"], r["status"]) == ("boom", "FAILED")
    assert r["error"].startswith("ZeroDivisionError")
    assert r["elapsed_s"] >= 0


def test_cli_verify_quick_cpu(tmp_path, capsys):
    out = tmp_path / "verify.json"
    assert cli.main(["verify", "--quick", "--cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "VERIFY: ALL PASSED"
    assert [json.loads(x)["status"] for x in lines[:-1]] == ["PASSED"] * 5
    report = json.loads(out.read_text())
    assert report["all_passed"] is True and report["backend"] == "cpu"
    assert [r["tier"] for r in report["tiers"]] == list(verify.TIERS)


def test_cli_verify_refuses_fence_gate(capsys):
    assert cli.main(["verify", "--quick", "--cpu", "--fence-gate"]) != 0
    assert "--fence-gate" in capsys.readouterr().err


def test_cli_verify_defaults_to_the_card():
    """Without ``--cpu`` the battery runs on the card, and raises where
    there is none: it never carries on on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["verify", "--quick"])
