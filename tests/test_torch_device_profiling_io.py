"""The port's small utilities on the CPU: ``utils/profiling.py``
(``Timing``, ``time_fn``, ``trace``), ``utils/device.py``'s memory sizes
(which raise without a card), and the ``codes/io.py`` readers
``parse_vlist_header`` and ``load_mat_code`` against the JAX package's, on
a C header and ``.mat`` files the test writes itself.
"""

import glob
import json
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse
import torch

from ldpc_erasure_codes_tpu import codes as jcodes
from ldpc_erasure_codes_tpu_torch import codes
from ldpc_erasure_codes_tpu_torch.codes import toy_code
from ldpc_erasure_codes_tpu_torch.utils import device, profiling

FIELDS = ("name", "n", "k", "rs_n", "rs_k", "gf_order")
ARRAYS = ("vlist_idx", "vlist_len", "vlist_val")


def _same_code(ours, ref):
    assert tuple(getattr(ours, f) for f in FIELDS) == tuple(getattr(ref, f) for f in FIELDS)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
        assert getattr(ours, f).dtype == getattr(ref, f).dtype, f


def test_time_fn_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2).sum()

    t = profiling.time_fn(fn, torch.ones(1000), reps=5, warmup=2, items_per_call=10)
    assert len(calls) == 7
    assert (t.name, t.reps, t.items) == ("fn", 5, 50)
    assert t.seconds > 0 and t.per_call == t.seconds / 5
    assert t.items_per_sec == 50 / t.seconds
    assert t.info_gbps(k=1530, symbol_bits=8192) == t.items_per_sec * 1530 * 8192 / 1e9


def test_timing_properties_without_time():
    t = profiling.Timing(name="x", reps=0, seconds=0.0, items=3)
    assert t.per_call == 0.0 and t.items_per_sec == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        (torch.arange(4096) * 3).sum()
    files = glob.glob(str(log_dir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("fn", [device.hbm_bytes, device.smem_bytes, device.l2_bytes])
def test_memory_sizes_need_a_card(fn, monkeypatch):
    with pytest.raises(ValueError, match="not a CUDA device"):
        fn("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def _vlist_rows(code):
    rows = []
    for r in range(code.m):
        d = int(code.vlist_len[r])
        rows.append([d] + [int(c) + 1 for c in code.vlist_idx[r, :d]])
    return rows


def _c_table(name, rows, width):
    body = ",\n".join("{" + ",".join(map(str, r + [0] * (width - len(r)))) + "}" for r in rows)
    return f"int {name}[{len(rows)}][{width}] = {{\n{body}\n}};\n"


def test_parse_vlist_header_master_layout_matches_jax(tmp_path):
    a, b = toy_code(48, 32, seed=1), toy_code(30, 18, row_weight=5, seed=2)
    rows = _vlist_rows(a) + _vlist_rows(b)
    width = max(len(r) for r in rows) + 2
    params = [[a.n, a.k, 0, a.m - 1, 0, 0], [b.n, b.k, a.m, a.m + b.m - 1, 255, 192]]
    path = tmp_path / "LDPC_Vlist_data.h"
    path.write_text("// generated\n" + _c_table("ldpc_params", params, 6)
                    + "/* the master list */\n"
                    + _c_table("parity_check_mat_Vlist_master", rows, width))
    ours, ref = codes.parse_vlist_header(str(path)), jcodes.parse_vlist_header(str(path))
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        _same_code(o, r)
    assert (ours[1].n, ours[1].rs_n) == (30, 255)
    np.testing.assert_array_equal(ours[0].h_dense, a.h_dense)


def test_parse_vlist_header_device_layout_matches_jax(tmp_path):
    a = toy_code(40, 24, seed=3)
    path = tmp_path / "device.h"
    path.write_text(_c_table("ldpc_params", [[99, 50], [a.n, a.k]], 2)
                    + _c_table("parity_check_mat_Vlist", _vlist_rows(a), a.dmax + 1))
    ours, ref = codes.parse_vlist_header(str(path)), jcodes.parse_vlist_header(str(path))
    assert len(ours) == len(ref) == 1
    _same_code(ours[0], ref[0])
    np.testing.assert_array_equal(ours[0].h_dense, a.h_dense)
    with pytest.raises(ValueError, match="ldpc_params"):
        (tmp_path / "empty.h").write_text("int x = 1;\n")
        codes.parse_vlist_header(str(tmp_path / "empty.h"))


@pytest.mark.parametrize("kind", ["sparse", "nb", "named"])
def test_load_mat_code_matches_jax(tmp_path, kind):
    a = toy_code(48, 32, seed=4)
    h = a.h_dense.astype(np.float64)
    path = os.path.join(tmp_path, "code.mat")
    if kind == "nb":
        vals = np.random.default_rng(5).integers(1, 256, h.shape)
        scipy.io.savemat(path, {"H_sparse": scipy.sparse.csc_matrix(h),
                                "H_sparse_nb": scipy.sparse.csc_matrix(h * vals)})
    else:
        scipy.io.savemat(path, {"H_sparse": scipy.sparse.csc_matrix(h)})
    kw = dict(name="mine", rs_n=255, rs_k=192) if kind == "named" else {}
    ours, ref = codes.load_mat_code(path, **kw), jcodes.load_mat_code(path, **kw)
    _same_code(ours, ref)
    assert ours.gf_order == (256 if kind == "nb" else 2)
    assert ours.name == ("mine" if kind == "named" else "n48_k32")
