"""The benchmark's files against BENCHMARK.json, the guard against JAX, and
the command's behaviour without a card."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch
from conftest import BENCH, CELLS, REPO

from codec_bench import harness

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_cells_match_their_files():
    assert sorted(w["name"] for w in SPEC["workloads"]) == CELLS
    for w in SPEC["workloads"]:
        f = json.load(open(os.path.join(BENCH, "workloads", f"{w['name']}.json")))
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        cell = harness.Cell.load(BENCH, w["name"])
        assert cell.config["name"] == w["config"]
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        f = json.load(open(os.path.join(REPO, c["file"])))
        assert f["name"] == c["name"] and f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_every_per_layer_metric_has_a_reader():
    readers = harness.metric_readers(BENCH)
    assert sorted(readers) == sorted(m["name"] for m in SPEC["per_layer"])
    perf = open(os.path.join(REPO, "PERF.md")).read()
    for m in SPEC["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"] and NAME.match(m["name"])
        assert set(m["workloads"]) <= set(CELLS) and m["moves"] == "info_gbps"
        assert f"\n| {m['layer']} |" in perf  # a row of PERF.md's list of layers
    assert [m["name"] for m in SPEC["end_to_end"]] == ["info_gbps", "batch_p95_ms", "setup_s"]


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldpc_erasure_codes_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ldpc_erasure_codes_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "ldpc_erasure_codes_tpu"]


GUARDED = textwrap.dedent("""
    import importlib, importlib.abc, io, pkgutil, sys, time
    BLOCK = ("jax", "jaxlib", "flax", "ldpc_erasure_codes_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCK:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import torch, codec_bench
    from codec_bench import harness
    for m in pkgutil.walk_packages(codec_bench.__path__, "codec_bench."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
    harness.metric_readers(harness.BENCH_ROOT)
    for cell in sys.argv[2:]:
        r = harness.run_cell(cell + "_t", seed=3, seconds=0.01, traced=False,
                             device=torch.device("cpu"), t_start=time.perf_counter(),
                             root=sys.argv[1], log=io.StringIO())
        assert r["correct"], r
    print(sorted({n.split(".")[0] for n in sys.modules} & set(BLOCK)))
""")


def test_nothing_imports_jax(small_root):
    """Every module of the benchmark, every mix and reader, and a run of every
    cell, in a process where importing JAX or the JAX package raises."""
    out = subprocess.run([sys.executable, "-c", GUARDED, small_root, *CELLS], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "codec_bench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "CUDA card" in out.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """With only BENCHMARK.json and the benchmark's folder, a run fails and
    prints no result: the program is not there."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "codec_bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time, torch; from codec_bench import harness; "
            f"harness.run_cell({CELLS[0]!r}, seed=1, seconds=0.01, traced=False, "
            "device=torch.device('cpu'), t_start=time.perf_counter())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    """One short run of the peel cell on the card: correct, every end-to-end
    metric, the device named."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "codec_bench.run", "--workload",
                          "ldpc2040.rx_peel.per1406", "--seed", "2147483999", "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"info_gbps", "batch_p95_ms", "setup_s"}
