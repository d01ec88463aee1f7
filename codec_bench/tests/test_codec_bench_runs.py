"""CPU rehearsals of whole runs: every cell passes its check, and the control
and every fault of :mod:`codec_bench.faults` make it fail."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest
import torch
from conftest import CELLS, SIM_CELLS

from codec_bench import faults, harness, port

SEED = 2**31 + 12345


def rehearse(root: str, cell: str, fault: str | None = None, seed: int = SEED) -> dict:
    return harness.run_cell(f"{cell}_t", seed=seed, seconds=0.05, traced=False,
                            device=torch.device("cpu"), t_start=time.perf_counter(), root=root,
                            fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    r = rehearse(small_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 16
    assert r["metrics"] == {}  # a CPU run reports no device metric
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"
    assert all(v == {"value": 0, "limit": 0} for v in r["checks"].values())


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail(small_root, cell, fault):
    r = rehearse(small_root, cell, fault)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0 or r["checks"].get("erasure_mismatch", {"value": 0})["value"] > 0


def test_writing_the_input_is_seen(small_root):
    r = rehearse(small_root, "ldpc2040.rx_peel.per1406", "writes_input")
    assert not r["correct"] and r["checks"]["pool_changed"]["value"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if c not in SIM_CELLS])
def test_a_fault_on_some_calls_is_seen(small_root, cell):
    """Frames altered on every third call: whatever their last call
    returned, the window's calls disagree."""
    r = rehearse(small_root, cell, "flaky")
    assert not r["correct"] and r["checks"]["value_unstable"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("cell", SIM_CELLS)
@pytest.mark.parametrize("fault", ["flaky", "altered"])
def test_a_simulation_wrong_on_some_visits_is_seen(small_root, cell, fault):
    """Counters off by one block error on some visits only: each such visit
    is a mismatch, and the others are not."""
    r = rehearse(small_root, cell, fault)
    visits = r["attempted"] // 32  # the twin's calls: 2 batches of 16 frames
    assert 0 < r["checks"]["stats_mismatch"]["value"] < visits, r["checks"]
    assert r["failed"] == r["checks"]["stats_mismatch"]["value"]


def test_jax_loaded_after_the_window_is_refused(small_root, tmp_path):
    """A metric reader that loads JAX on import: the run raises and returns
    no result, although the window had closed before the readers load."""
    root = str(tmp_path / "root")
    shutil.copytree(small_root, root)
    with open(os.path.join(root, "metrics", "zz_loads_jax.py"), "w") as f:
        f.write("import sys, types\n"
                "sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
                "UNIT = '%'\n\n\ndef read(view):\n    return None\n")
    had = "jax" in sys.modules
    try:
        with pytest.raises(RuntimeError, match=r"\['jax'\]"):
            rehearse(root, CELLS[0])
    finally:
        if not had:
            sys.modules.pop("jax", None)


def test_a_wrong_set_up_encode_is_seen(small_root, monkeypatch):
    encode = port.encode

    def wrong(config, arrays, source):
        out = encode(config, arrays, source)
        out[:, -1, 0] ^= 1  # the last parity symbol of every frame
        return out

    monkeypatch.setattr(port, "encode", wrong)
    r = rehearse(small_root, "rs255.rx.per1875")
    assert not r["correct"] and r["checks"]["input_mismatch"]["value"] > 0


def test_an_unsampled_pool_is_seen(small_root, monkeypatch):
    monkeypatch.setattr(harness.Sampler, "take", lambda self, j, out: None)
    r = rehearse(small_root, "ldpc2040.tx_encode")
    assert not r["correct"] and r["checks"]["batches_unchecked"]["value"] == 2


def test_new_workload_file_is_found_and_run(small_root, tmp_path):
    """A cell added as data files alone (a traffic file with another loss
    model, and a workload file) runs with no other file edited."""
    root = str(tmp_path / "root")
    shutil.copytree(small_root, root)
    with open(os.path.join(root, "traffic", "rx_peel.burst_t.json"), "w") as f:
        json.dump({"mix": "rx_peel", "batch": 8, "pool_batches": 2, "sample_frames": 8,
                   "loss": {"model": "gilbert_elliott", "alpha": 0.05, "beta": 0.6,
                            "transition": 0.1, "bias": 10.0}}, f)
    with open(os.path.join(root, "workloads", "ldpc2040.rx_peel.burst_t.json"), "w") as f:
        json.dump({"config": "ldpc2040_k1530_s8192_t", "traffic": "rx_peel.burst_t", "chips": 1,
                   "why": "bursty loss"}, f)
    r = harness.run_cell("ldpc2040.rx_peel.burst_t", seed=7, seconds=0.05, traced=False,
                         device=torch.device("cpu"), t_start=time.perf_counter(), root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {}
