"""The port's NumPy oracle (``utils/oracle.py``) against the JAX package's,
and ``utils/verify.py``'s use of it as the second judge, on the CPU.

tests/test_oracle.py is the template: each oracle function runs on the
same NumPy inputs on both sides (codes from the same seeds, frames and
erasures from fixed seeds) and must give equal outputs. The oracle is
host code, so the codes stay small or the calls few.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu import codes as jcodes
from ldpc_erasure_codes_tpu import gf as jgf
from ldpc_erasure_codes_tpu.codes import gmatrix as jgm
from ldpc_erasure_codes_tpu.utils import oracle as jor
from ldpc_erasure_codes_tpu_torch import codes, gf
from ldpc_erasure_codes_tpu_torch.codes import gmatrix
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.utils import oracle, verify
from torch_port_cases import random_words, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (port code, JAX code) pairs, each made from the same seed on both sides.
CODES = {
    "toy": lambda: (codes.toy_code(), jcodes.toy_code()),
    "toy_gf256": lambda: (codes.toy_code(gf_order=256, seed=2),
                          jcodes.toy_code(gf_order=256, seed=2)),
    "n2000_k1000": lambda: (codes.get_code("n2000_k1000"), jcodes.get_code("n2000_k1000")),
    "n2000_k1000_gf256": lambda: (codes.get_code("n2000_k1000_gf256"),
                                  jcodes.get_code("n2000_k1000_gf256")),
}


def _erase(rng, cw, per):
    recv = cw.copy()
    recv[rng.random(cw.size) <= per] = oracle.ERASED
    return recv


def test_gf_matvec_np_matches_jax():
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 256, (7, 11))
    vec = rng.integers(0, 256, 11)
    np.testing.assert_array_equal(gf.gf_matvec_np(mat, vec), jgf.gf_matvec_np(mat, vec))


@pytest.mark.parametrize("name,pers", [("toy", (0.1, 0.3, 0.5)), ("n2000_k1000", (0.1, 0.45))])
def test_binary_encode_peel_hybrid_match_jax(name, pers):
    """``encode_triangular``, ``peel_decode`` (full and 10 sweeps) and
    ``hybrid_ml_decode`` on random frames, solved, stuck and singular."""
    code, jcode = CODES[name]()
    rng = np.random.default_rng(10)
    for per in pers:
        src = rng.integers(0, 2, code.k)
        cw = oracle.encode_triangular(code, src)
        np.testing.assert_array_equal(cw, jor.encode_triangular(jcode, src))
        recv = _erase(rng, cw, per)
        for it in (50, 10):
            got, want = oracle.peel_decode(code, recv, it), jor.peel_decode(jcode, recv, it)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        got, want = oracle.hybrid_ml_decode(code, recv), jor.hybrid_ml_decode(jcode, recv)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("name,pers", [("toy_gf256", (0.1, 0.3, 0.5)),
                                       ("n2000_k1000_gf256", (0.25,))])
def test_nb_encode_peel_hybrid_match_jax(name, pers):
    code, jcode = CODES[name]()
    rng = np.random.default_rng(14)
    for per in pers:
        src = rng.integers(0, 256, code.k)
        cw = oracle.encode_triangular_nb(code, src)
        np.testing.assert_array_equal(cw, jor.encode_triangular_nb(jcode, src))
        recv = _erase(rng, cw, per)
        got, want = oracle.peel_decode_nb(code, recv, 10), jor.peel_decode_nb(jcode, recv, 10)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        got, want = oracle.hybrid_ml_decode_nb(code, recv), jor.hybrid_ml_decode_nb(jcode, recv)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_ml_decode_from_g_matches_jax():
    """From the toy code's systematic G: decodable, rank-deficient and
    systematic-only patterns."""
    code = codes.toy_code(n=30, k=18, seed=5)
    g, _ = gmatrix.systematic_g_from_h(code.h_dense)
    np.testing.assert_array_equal(g, jgm.systematic_g_from_h(code.h_dense)[0])
    rng = np.random.default_rng(4)
    flags = set()
    for per in (0.0, 0.1, 0.2, 0.3, 0.4, 0.5):
        msg = rng.integers(0, 2, 18)
        cw = (msg @ g) & 1
        recv = _erase(rng, cw.astype(np.int64), per)
        got, want = oracle.ml_decode_from_g(g, recv, 18), jor.ml_decode_from_g(g, recv, 18)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        if got[1]:
            np.testing.assert_array_equal(got[0], msg)
        flags.add(got[1])
    assert flags == {True, False}


def test_rs_decode_matches_jax():
    """The (7,5) Vandermonde code of tests/test_oracle.py, and a rank-
    deficient system (a zero column of G received)."""
    t = gf.build_tables()
    k, n = 5, 7
    g = t.exp[(np.arange(1, k + 1)[:, None] * np.arange(1, n + 1)[None, :]) % 255]
    g_sys = gf.gf_matmul_np(gf.gf_inv_matrix_np(g[:, :k]), g)
    rng = np.random.default_rng(16)
    for _ in range(40):
        msg = rng.integers(0, 256, k)
        cw = gf.gf_matvec_np(g_sys.T.astype(np.int64), msg)
        keep = np.sort(rng.choice(n, size=k, replace=False))
        got = oracle.rs_decode(keep, cw[keep], g_sys, k)
        np.testing.assert_array_equal(got, jor.rs_decode(keep, cw[keep], g_sys, k))
        np.testing.assert_array_equal(got, msg)
    g_bad = g_sys.copy()
    g_bad[:, 6] = 0
    keep = np.array([0, 1, 2, 5, 6])
    np.testing.assert_array_equal(oracle.rs_decode(keep, cw[keep], g_bad, k),
                                  jor.rs_decode(keep, cw[keep], g_bad, k))


@pytest.mark.parametrize("state", [0, 1])
def test_gilbert_elliott_matches_jax(state):
    args = (2000, 0.01, 0.4, 0.2, 5.0, state)
    got = oracle.gilbert_elliott_sample(np.random.default_rng(17), *args)
    want = jor.gilbert_elliott_sample(np.random.default_rng(17), *args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert oracle.gilbert_elliott_steady_state(0.01, 0.4) == jor.gilbert_elliott_steady_state(
        0.01, 0.4)


def _toy_decode(gf_order, early):
    """A CPU peel of the toy code (8 frames, PER .1: solved and stuck
    frames) and its check report."""
    code = codes.toy_code(gf_order=gf_order)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(21)
    if gf_order == 256:
        src = torch.from_numpy(rng.integers(0, 256, (8, code.k, 8), dtype=np.uint8))
    else:
        src = to_torch(random_words(rng, (8, code.k, 2)))
    cw = encode_packed(arrays, src, gf_order=gf_order)
    mask = torch.from_numpy(rng.random((8, code.n)) < 0.1)
    kw = dict(max_iters=50, early_stop_k=code.k if early else None)
    v, e, it = peel_decode(arrays, cw, mask, gf_order=gf_order, **kw)
    check = verify.check_nb if gf_order == 256 else verify.check_peel
    return (lambda e_, it_: check(arrays, cw, mask, v, e_, it_, **kw)), e, it


@pytest.mark.parametrize("gf_order", [2, 256])
@pytest.mark.parametrize("early", [False, True])
def test_check_peel_consults_the_oracle(gf_order, early):
    """``check_peel`` / ``check_nb``: ok on a correct decode, with the
    oracle's fields at 0; not ok, on the oracle's fields, when a stuck
    symbol is marked resolved or an iteration count is raised past the
    oracle's (without early stop also when one is lowered, or a resolved
    symbol is marked erased: there the mask and sweeps must be equal)."""
    check, e, it = _toy_decode(gf_order, early)
    rep = check(e, it)
    assert rep["ok"] and rep["ref_frames"] == 8, rep
    assert rep["oracle_mask_mismatches"] == rep["oracle_iter_mismatches"] == 0
    assert rep["oracle_seconds"] >= 0
    it_np = it.numpy()
    assert (it_np < 50).any() and (it_np == 50).any()  # solved and stuck frames
    f = int(np.argmax(it_np == 50))  # stuck: the oracle's fixed point too
    bad_e = e.clone()
    bad_e[f, int(np.argmax(e[f].numpy()))] = False
    rep = check(bad_e, it)
    assert not rep["ok"] and rep["oracle_mask_mismatches"] == 1, rep
    bad_it = it.clone()
    bad_it[0] = 51
    rep = check(e, bad_it)
    assert not rep["ok"] and rep["oracle_iter_mismatches"] == 1, rep
    if not early:
        bad_it = it.clone()
        bad_it[int(np.argmax(it.numpy() < 50))] -= 1
        assert check(e, bad_it)["oracle_iter_mismatches"] == 1
        f, c = map(int, np.argwhere(~e.numpy())[0])
        bad_e = e.clone()
        bad_e[f, c] = True
        assert check(bad_e, it)["oracle_mask_mismatches"] == 1


def test_new_modules_import_no_jax():
    """The oracle, the generators, the G-matrix tools, ``save_code``,
    ``gf_matvec_np``, and the stream datapath, plot, profiling, device,
    GF(256) and code-reader modules import and run with ``jax`` and the JAX
    package unimportable."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ldpc_erasure_codes_tpu'] = None\n"
        "import numpy as np\n"
        "from ldpc_erasure_codes_tpu_torch.codes import gen_column_wise, save_code, toy_code\n"
        "from ldpc_erasure_codes_tpu_torch.codes.gmatrix import gf2_rank\n"
        "from ldpc_erasure_codes_tpu_torch.gf import gf_matvec_np\n"
        "from ldpc_erasure_codes_tpu_torch.utils import oracle, verify\n"
        "c = toy_code()\n"
        "cw = oracle.encode_triangular(c, np.ones(c.k, int))\n"
        "assert oracle.peel_decode(c, cw)[1] == 1 and gf2_rank(c.h_dense) == c.m\n"
        "gen_column_wise([(51, 4)], [(102, 2)], seed=9, max_tries=120)\n"
        "assert gf_matvec_np(np.eye(3, dtype=int), np.arange(3)).tolist() == [0, 1, 2]\n"
        "import torch\n"
        "from ldpc_erasure_codes_tpu_torch.codes import load_mat_code, parse_vlist_header\n"
        "from ldpc_erasure_codes_tpu_torch.gf import (gf_add, gf_matmul_bitimage, gf_mul_arith,\n"
        "    gf_mul_log, gf_mul_table, int_matmul, mod2_matmul)\n"
        "from ldpc_erasure_codes_tpu_torch.rs import stream\n"
        "from ldpc_erasure_codes_tpu_torch.sim import plot\n"
        "from ldpc_erasure_codes_tpu_torch.utils import cli, device, profiling, streaming, udp, vita\n"
        "from ldpc_erasure_codes_tpu_torch.utils.device import hbm_bytes, l2_bytes, smem_bytes\n"
        "a = torch.arange(256, dtype=torch.uint8)\n"
        "assert torch.equal(gf_mul_table(a, a), gf_mul_log(a, a))\n"
        "asm = streaming.BlockAssembler(4, 2, 4, decode_at_k=False)\n"
        "asm.push(streaming.make_packet(0, 1, 0, vita.VitaEmitter(1).emit(b'abcd')[0][1][8:]))\n"
        "assert asm.stats['packets'] == 1 and udp.flow_window(1 << 20, 1032) > 16\n"
        "assert stream.xor_digest(torch.zeros((2, 3, 4), dtype=torch.uint8)).tolist() == [0] * 4\n"
        "assert profiling.time_fn(lambda: None, reps=1).reps == 1\n"
        "assert not [m for m, mod in sys.modules.items() if mod is not None and (\n"
        "    m == 'jax' or m.startswith(('jax.', 'ldpc_erasure_codes_tpu.')))]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
