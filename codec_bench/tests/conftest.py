"""A small copy of the benchmark's data for CPU rehearsals.

Every cell gets a twin ``<cell>_t`` at a size the CPU runs in seconds: its
configuration with 16-byte symbols, its traffic with 8 frames a batch, 2 pool
batches and every frame checked at each visit (a simulation's: 16 frames a
batch, 2 batches a call, 2 pool calls). The codes, the mixes, the
metric readers and the reference are the benchmark's own.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CELLS = sorted(os.path.basename(p)[: -len(".json")]
               for p in glob.glob(os.path.join(BENCH, "workloads", "*.json")))


def _is_sim(cell: str) -> bool:
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        traffic = json.load(f)["traffic"]
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        return json.load(f)["mix"].startswith("sim")


SIM_CELLS = [c for c in CELLS if _is_sim(c)]


def small_copy(dst: str) -> str:
    """Copy the benchmark's data into ``dst`` and add the ``_t`` twins."""
    for sub in ("configs", "traffic", "workloads", "mixes", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(dst, sub))
    os.makedirs(os.path.join(dst, "reference"))
    for f in glob.glob(os.path.join(BENCH, "reference", "*.npz")):
        shutil.copy(f, os.path.join(dst, "reference"))

    def twin(sub: str, change) -> None:
        for path in glob.glob(os.path.join(dst, sub, "*.json")):
            with open(path) as f:
                obj = json.load(f)
            change(obj)
            with open(path[: -len(".json")] + "_t.json", "w") as f:
                json.dump(obj, f)

    twin("configs", lambda c: c.update(symbol_bytes=16))
    twin("traffic", lambda t: t.update(batch=16, steps_per_call=2, pool_calls=2)
         if t["mix"].startswith("sim") else t.update(batch=8, pool_batches=2, sample_frames=8))
    twin("workloads", lambda w: w.update(config=w["config"] + "_t", traffic=w["traffic"] + "_t"))
    return dst


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> str:
    return small_copy(str(tmp_path_factory.mktemp("codec_bench")))
