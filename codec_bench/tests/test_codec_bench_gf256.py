"""A GF(256)-lifted LDPC configuration, taken by the harness from data files
alone.

The lift's coefficients are frozen beside the binary code file and checked
against the program's at set-up. The reference's GF(256) codewords and its
maximum-likelihood rule must agree with the program's CPU path, and hold on
checks of their own: ``h_nb c = 0`` with the frozen tables, and frames that
the field decides (recoverable over GF(256), not over GF(2)). A lifted cell
added to a copy of the benchmark as a configuration, traffic and workload
files runs correct on the CPU, and the control and every fault fail it.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, REPO

from codec_bench import faults, harness, port, traffic
from codec_bench.reference import codes, recovery

CPU = torch.device("cpu")
LDPC = json.load(open(os.path.join(BENCH, "configs", "ldpc2040_k1530_s8192.json")))
LIFT_FILE = "reference/n2040_k1530_gf256.npz"
LIFT_SHA256 = "e23977f94bd4e15fdee73a6a05ec6598ef7f8eb92d9f8b920d2d3b13f6f3d9e7"


def lifted_config(symbol_bytes: int = 1024) -> dict:
    """The seed-0 GF(256) lift of the (2040, 1530) code, as a configuration
    file holds it: the binary code's keys, ``gf_order`` and ``lift``."""
    cfg = json.loads(json.dumps(LDPC))
    cfg.update(name="ldpc2040_gf256_s8192", symbol_bytes=symbol_bytes,
               source="Matlab/ErasureCodes_NonBinaryLDPCSim.m:52-58: the GF(256) lift of the "
                      "(2040,1530) LDPC, decoded by My_LDPC_HybridML_NonBinary_Erasure_Decoder.m")
    cfg["code"].update(port_name="n2040_k1530_gf256", gf_order=256,
                       lift={"seed": 0, "file": LIFT_FILE, "sha256": LIFT_SHA256})
    cfg["guarantees"][-1] = ("the hybrid with escalation recovers every frame whose erased columns "
                             "of H are independent over GF(256) (maximum likelihood), and delivers all n")
    return cfg


LIFTED = lifted_config()


def words(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=g)


@pytest.fixture(scope="module")
def lifted():
    return codes.load(LIFTED["code"], BENCH)


@pytest.mark.parametrize("w", [1, 4])
def test_lifted_encoder_agrees(lifted, w):
    arrays = port.code_arrays(LIFTED, CPU)
    src = words((3, 1530, w), 30 + w)
    assert torch.equal(lifted.codewords(src), port.encode(LIFTED, arrays, src))


def test_lifted_encoder_blocks(lifted):
    src = words((4, 1530, 2), 31)
    assert torch.equal(lifted.codewords(src, block_bytes=1), lifted.codewords(src))


def test_lifted_codewords_satisfy_h_nb(lifted):
    """Every check's sum of coefficient times byte is 0, by the frozen
    tables and the lift file read here, one check row at a time."""
    gf = codes.GF256.frozen()
    with np.load(os.path.join(BENCH, LIFT_FILE)) as z:
        val = np.asarray(z["vlist_val"], dtype=np.int64)
    with np.load(os.path.join(BENCH, LDPC["code"]["file"])) as z:
        idx, ln = z["vlist_idx"], z["vlist_len"]
    cw = lifted.codewords(words((3, 1530, 2), 32)).view(torch.uint8).numpy()  # (F, n, 8)
    assert np.any(cw[:, 1530:])
    for r in range(idx.shape[0]):
        d = int(ln[r])
        terms = gf.mul(val[r, :d, None, None], cw[:, idx[r, :d]].transpose(1, 0, 2))
        assert not np.any(np.bitwise_xor.reduce(terms, axis=0)), r


def test_lifted_parity_map_is_not_binary(lifted):
    """The lift changes the map: the image's rows sum past float16's exact
    range, which the encoder's pieces of EXACT_SUM bits keep exact."""
    binary = codes.load(LDPC["code"], BENCH)
    assert lifted.a.shape == (8 * 510, 8 * 1530) and lifted.element_bits == 8
    assert int(lifted.a.sum(axis=1).max()) > codes.EXACT_SUM >= binary.a.shape[1]


@pytest.mark.parametrize("per", [0.2031, 0.24, 0.26])
def test_gf256_ml_rank_matches_the_programs_rank_check(lifted, per):
    """On the four widest residuals of 32 frames that the program's plain
    GF(256) rank loop can hold (at most m erasures)."""
    from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check_reference

    arrays = port.code_arrays(LIFTED, CPU)
    mask = traffic.loss({"model": "iid", "per": per}, 6, 0, 1, (32, 2040), CPU)
    left = recovery.peel_closure(lifted, mask)
    count = left.sum(dim=1)
    sel = torch.argsort(torch.where(count <= 510, count, -1), descending=True, stable=True)[:4]
    failed = ge_rank_check_reference(arrays, left[sel], emax=int(count[sel].max()), gf_order=256)
    assert torch.equal(recovery.ml_rank(lifted, mask[sel]), ~failed)
    assert torch.equal(recovery.ml_rank(lifted, left[sel]), ~failed)


def test_the_field_decides_some_frames(lifted):
    """At PER .24 some frame is recoverable over GF(256) and not over GF(2)."""
    binary = codes.load(LDPC["code"], BENCH)
    mask = traffic.loss({"model": "iid", "per": 0.24}, 6, 0, 1, (32, 2040), CPU)
    nb, f2 = recovery.ml_rank(lifted, mask), recovery.ml_rank(binary, mask)
    assert torch.any(nb & ~f2) and torch.any(~nb)


def test_gf256_ml_rank_edge_masks(lifted):
    """No erasure; every parity symbol (H_p is invertible); m + 1 symbols;
    and source symbol 0 with all parity symbols but one, p: dependent iff
    column 0 of H lies in the span of the other parity columns, that is iff
    its coordinate ``P[0, p]`` over H_p's columns is 0."""
    p = codes.ldpc_parity_gf256(lifted.h_nb, 1530, codes.GF256.frozen())[0]
    p_dep, p_ind = int(np.flatnonzero(p == 0)[0]), int(np.flatnonzero(p)[0])
    mask = torch.zeros((5, 2040), dtype=torch.bool)
    mask[1:, 1530:] = True
    mask[2, 0] = True
    mask[3:, 0] = True
    mask[3, 1530 + p_dep] = False
    mask[4, 1530 + p_ind] = False
    assert recovery.ml_rank(lifted, mask).tolist() == [True, True, False, False, True]


def test_frozen_lift_is_the_programs():
    from ldpc_erasure_codes_tpu_torch.codes.io import get_code

    path = os.path.join(BENCH, LIFT_FILE)
    assert port.sha256(path) == LIFT_SHA256
    with np.load(path) as z:
        frozen = z["vlist_val"]
    assert frozen.dtype == np.uint8
    assert np.array_equal(frozen, get_code("n2040_k1530").lift_to_gf256(seed=0).vlist_val)
    assert np.array_equal(frozen, get_code(LIFTED["code"]["port_name"]).vlist_val)
    port.check_code_files(LIFTED, BENCH, REPO)


def test_changed_lift_file_is_refused(tmp_path):
    """One coefficient changed: refused by its digest, and, with the digest
    recorded anew, by the program's coefficients."""
    os.makedirs(tmp_path / "reference")
    for f in (LDPC["code"]["file"], LIFT_FILE):
        shutil.copy(os.path.join(BENCH, f), tmp_path / f)
    with np.load(tmp_path / LIFT_FILE) as z:
        val = z["vlist_val"].copy()
    val[7, 0] = val[7, 0] % 255 + 1
    np.savez(tmp_path / LIFT_FILE, vlist_val=val)
    with pytest.raises(ValueError, match="sha256"):
        port.check_code_files(LIFTED, str(tmp_path), REPO)
    cfg = json.loads(json.dumps(LIFTED))
    cfg["code"]["lift"]["sha256"] = port.sha256(str(tmp_path / LIFT_FILE))
    with pytest.raises(ValueError, match="coefficients differ"):
        port.check_code_files(cfg, str(tmp_path), REPO)


LIFTED_CELLS = ["ldpc2040_gf256.rx_hybrid.iid2031_t", "ldpc2040_gf256.rx_hybrid.burst_t",
                "ldpc2040_gf256.tx_encode_t"]


@pytest.fixture(scope="module")
def lifted_root(small_root, tmp_path_factory) -> str:
    """A copy of the CPU-sized benchmark that gains a lifted configuration
    with 16-byte symbols, two hybrid traffic files of 4 frames a batch (the
    program's plain GF(256) GE takes seconds a frame on the CPU) and their
    workloads, and a workload that sends with the encode twin's traffic, as
    data files alone."""
    root = str(tmp_path_factory.mktemp("lifted") / "root")
    shutil.copytree(small_root, root)

    def write(sub, name, obj):
        with open(os.path.join(root, sub, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    write("configs", "ldpc2040_gf256_s8192_t", lifted_config(symbol_bytes=16))
    small = {"mix": "rx_hybrid", "batch": 4, "pool_batches": 2, "sample_frames": 4}
    write("traffic", "rx_hybrid.iid2031_t", dict(small, loss={"model": "iid", "per": 0.2031}))
    write("traffic", "rx_hybrid.burst_t", dict(small, loss={
        "model": "gilbert_elliott", "alpha": 0.1, "beta": 0.6, "transition": 0.1, "bias": 10.0}))
    for cell, t in zip(LIFTED_CELLS, ("rx_hybrid.iid2031_t", "rx_hybrid.burst_t",
                                      "tx_encode.b2048_t")):
        write("workloads", cell, {"config": "ldpc2040_gf256_s8192_t", "traffic": t, "chips": 1,
                                  "why": f"the GF(256) lift, {t}"})
    return root


def rehearse(root, cell, fault=None):
    return harness.run_cell(cell, seed=2**31 + 2031, seconds=0.05, traced=False, device=CPU,
                            t_start=time.perf_counter(), root=root, fault=fault)


@pytest.mark.parametrize("cell", LIFTED_CELLS)
def test_lifted_cell_is_correct(lifted_root, cell):
    r = rehearse(lifted_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 8 and r["metrics"] == {}
    assert all(v == {"value": 0, "limit": 0} for v in r["checks"].values())


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell", LIFTED_CELLS)
def test_lifted_cell_control_and_faults_fail(lifted_root, cell, fault):
    r = rehearse(lifted_root, cell, fault)
    assert not r["correct"], (fault, r["checks"])
