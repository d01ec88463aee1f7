"""The port's parallel layer over ``torch.distributed`` (gloo) on the CPU.

1. At world size 1 the sharded step returns exactly the unsharded step's
   statistics, and ``run_fer_point(mesh=...)`` the same counts.
2. Two ``_mp_worker`` processes (gloo, ``file://`` rendezvous in the test's
   temporary directory, so no ports race) report identical statistics,
   equal to the sum of single-process runs of shard 0's and shard 1's
   streams (rank r draws shard r's).
3. ``cli scaling --device cpu --devices 1``.
4. ``dryrun_multichip(2)`` over two processes: all four styles.

The spawned processes import the port alone (torch, no JAX), as on the
machine with the card; each gets a timeout of 120 s.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from ldpc_erasure_codes_tpu_torch import sim
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.parallel import (
    default_mesh,
    make_mesh,
    multihost,
    shard_batch,
    shard_sim_step,
)
from ldpc_erasure_codes_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE, BATCH, PER, STEPS = "n2000_k1000", 16, 0.3, 2


@pytest.fixture
def world1():
    """A one-rank gloo group for the test, destroyed after it."""
    multihost.initialize("cpu")
    try:
        yield
    finally:
        multihost.shutdown()


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return env


def _run_all(cmds, tmp_path):
    """Start every command, then wait for each (120 s at most); returns
    their stdout."""
    procs = [subprocess.Popen(c, cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _peel_cfg(batch=BATCH):
    return sim.SimConfig(code=CODE, batch=batch, track_values=False,
                         decoder=sim.DecoderConfig(kind="peel", max_iters=20, early_stop_k=True))


@pytest.mark.parametrize("cfg", [
    sim.SimConfig(code="toy", batch=8, steps_per_call=2,
                  decoder=sim.DecoderConfig(kind="hybrid", peel_iters=4, emax=8)),
    sim.SimConfig(code="toy", batch=8, track_values=False, symbol_words=2,
                  decoder=sim.DecoderConfig(kind="hybrid", max_iters=30, emax=16,
                                            ge_subbatch=4)),
], ids=["values", "pattern_only"])
def test_world1_sharded_step_is_the_step(world1, cfg):
    code = toy_code(48, 32, seed=3)
    step = sim.make_sim_step(code, cfg, device="cpu")
    sharded = shard_sim_step(step, default_mesh())
    for call in (0, 5):
        assert sharded(call, 0.15).to_host() == step(call, 0.15).to_host()
    # Other shards draw other streams.
    assert step(0, 0.15, shard=1).to_host() != step(0, 0.15).to_host()


def test_world1_fer_point_counts_equal(world1):
    code = get_code(CODE)
    cfg = _peel_cfg(16)
    kw = dict(target_errors=3, max_frames=48, device="cpu")
    plain = sim.run_fer_point(code, cfg, 0.45, **kw)
    sharded = sim.run_fer_point(code, cfg, 0.45, mesh=default_mesh(), **kw)
    for f in ("frames", "block_errors", "rs_block_errors", "ml_failed", "escalations",
              "measured_per", "mean_iters"):
        assert getattr(sharded, f) == getattr(plain, f), f
    assert plain.frames > 0


def test_shard_batch_blocks(world1):
    mesh = make_mesh((1, 1), ("data", "lane"))
    x = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    assert torch.equal(shard_batch(x, mesh, lane_axis_dim=2), x)
    assert torch.equal(shard_batch(x[:, :, 0], mesh), x[:, :, 0])


def test_two_processes_sum_their_shards(tmp_path):
    rdv = f"file://{tmp_path / 'rendezvous'}"
    cmds = [[sys.executable, "-m", "ldpc_erasure_codes_tpu_torch.parallel._mp_worker",
             "--init-method", rdv, "--num-processes", "2", "--process-id", str(r),
             "--device", "cpu", "--out", str(tmp_path / f"rank{r}.json"), "--code", CODE,
             "--batch", str(BATCH), "--per", str(PER), "--steps", str(STEPS)]
            for r in range(2)]
    _run_all(cmds, tmp_path)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2))
    assert r0["info"] == {"process_index": 0, "process_count": 2, "local_devices": 1,
                          "global_devices": 2}
    assert r1["info"]["process_index"] == 1 and r0["mesh_devices"] == 2
    assert r0["stats"] == r1["stats"]
    assert r0["stats"]["frames"] == 2 * BATCH * STEPS
    step = sim.make_sim_step(get_code(CODE), _peel_cfg(), device="cpu")
    total = None
    for shard in range(2):
        for i in range(STEPS):
            s = step(i, PER, shard=shard)
            total = s if total is None else total + s
    assert total.to_host()._asdict() == r0["stats"]


def test_scaling_cli_one_device(capsys):
    assert cli.main(["scaling", "--device", "cpu", "--devices", "1", "--batch", "16",
                     "--reps", "2", "--steps-per-call", "1"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    point = json.loads(line)
    assert point["devices"] == 1 and point["frames"] == 32 and point["efficiency"] == 1.0
    assert point["frames_per_sec"] > 0


def test_dryrun_two_processes(tmp_path):
    script = (
        "import sys\n"
        "from ldpc_erasure_codes_tpu_torch.parallel import multihost\n"
        "from ldpc_erasure_codes_tpu_torch.parallel.dryrun import dryrun_multichip\n"
        f"multihost.initialize('cpu', init_method={'file://' + str(tmp_path / 'rdv')!r}, "
        "world_size=2, rank=int(sys.argv[1]))\n"
        "dryrun_multichip(2)\n"
        "multihost.shutdown()\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    outs = _run_all([[sys.executable, "-c", script, str(r)] for r in range(2)], tmp_path)
    assert [o.strip() for o in outs] == ["ok", "ok"]
