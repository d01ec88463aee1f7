"""The port's native I/O library (``utils/native.py``), golden-vector
protocol (``utils/golden.py``) and ``cli golden``, ``census`` and ``gen``,
against the JAX package's, on the CPU.

tests/test_native_golden.py is the template. The generators draw from
``np.random.default_rng(seed)`` in JAX's order, so both packages write the
same bytes; JAX-written sets go through the port's verifiers (the plain
versions of its kernels here).
"""

import os

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes import load_code as jax_load_code
from ldpc_erasure_codes_tpu.codes import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu.utils import golden as jax_golden
from ldpc_erasure_codes_tpu.utils import native as jax_native
from ldpc_erasure_codes_tpu_torch.codes import get_code, load_code, toy_code
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.utils import cli, golden, native


def test_native_lib_builds_into_the_port():
    assert native.have_native()
    lib = native.load_native()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libldpc_io_")


@pytest.mark.parametrize("fallback", [False, True])
def test_vector_file_roundtrip(tmp_path, monkeypatch, fallback):
    """Native and NumPy paths write the bytes JAX's writes and read them
    back; a reference file's comma-separated extras are ignored."""
    if fallback:
        monkeypatch.setattr(native, "load_native", lambda: None)
    vals = np.array([1, 2, 65535, 42, 0, 7], dtype=np.uint16)
    native.write_vector_file(tmp_path / "v.txt", vals)
    jax_native.write_vector_file(tmp_path / "j.txt", vals)
    assert (tmp_path / "v.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(native.read_vector_file(tmp_path / "j.txt"), vals)
    (tmp_path / "v2.txt").write_text("5, 99\n6, 98\n")
    np.testing.assert_array_equal(native.read_vector_file(tmp_path / "v2.txt"), [5, 6])


@pytest.mark.parametrize("fallback", [False, True])
def test_symbols_and_bitplanes_match_jax(monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(native, "load_native", lambda: None)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 16, size=37, dtype=np.uint16)
    vals[[3, 9]] = 0
    sym, er = native.expand_symbols(vals, 5)
    jsym, jer = jax_native.expand_symbols(vals, 5)
    np.testing.assert_array_equal(sym, jsym)
    np.testing.assert_array_equal(er, jer)
    assert sym.dtype == np.uint32 and er.dtype == bool
    np.testing.assert_array_equal(native.collapse_symbols(sym), jax_native.collapse_symbols(jsym))
    bad = sym.copy()
    bad[2, 4] ^= 1 << 31  # the top bit of one lane
    with pytest.raises(ValueError):
        native.collapse_symbols(bad)
    bits = rng.integers(0, 2, size=(3, 96, 17), dtype=np.uint8)
    packed = native.pack_bitplanes(bits)
    np.testing.assert_array_equal(packed, jax_native.pack_bitplanes(bits))
    np.testing.assert_array_equal(native.unpack_bitplanes(packed), bits)
    np.testing.assert_array_equal(native.unpack_bitplanes(packed),
                                  jax_native.unpack_bitplanes(packed))


@pytest.mark.parametrize("fallback", [False, True])
def test_vlist_header_matches_jax(tmp_path, monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(native, "load_native", lambda: None)
    code = toy_code(n=24, k=16, seed=2)
    native.write_vlist_header(tmp_path / "p.h", code.vlist_idx, code.vlist_len,
                              cols=code.dmax + 2)
    jax_native.write_vlist_header(tmp_path / "j.h", code.vlist_idx, code.vlist_len,
                                  cols=code.dmax + 2)
    assert (tmp_path / "p.h").read_bytes() == (tmp_path / "j.h").read_bytes()
    ints = native.parse_header_ints(tmp_path / "p.h")
    np.testing.assert_array_equal(ints, jax_native.parse_header_ints(tmp_path / "j.h"))
    rows = ints.reshape(code.m, code.dmax + 2)
    np.testing.assert_array_equal(rows[:, 0], code.vlist_len)


# (name, port generator call, JAX generator call), each with its seed.
SETS = {
    "binary": (lambda d: golden.generate_golden(toy_code(n=48, k=32, seed=1), d, frames=3,
                                                per=0.2, seed=1),
               lambda d: jax_golden.generate_golden(jax_toy_code(n=48, k=32, seed=1), d,
                                                    frames=3, per=0.2, seed=1)),
    "nb": (lambda d: golden.generate_golden_nb(toy_code(n=60, k=36, seed=2).lift_to_gf256(), d,
                                               frames=3, per=0.1, seed=1),
           lambda d: jax_golden.generate_golden_nb(
               jax_toy_code(n=60, k=36, seed=2).lift_to_gf256(), d, frames=3, per=0.1, seed=1)),
    "rs": (lambda d: golden.generate_golden_rs(15, 11, d, frames=4, per=0.2, seed=3),
           lambda d: jax_golden.generate_golden_rs(15, 11, d, frames=4, per=0.2, seed=3)),
}


@pytest.mark.parametrize("kind", list(SETS))
def test_generators_write_jax_bytes(tmp_path, kind):
    port, jax = SETS[kind]
    gs, jgs = port(tmp_path / "port"), jax(tmp_path / "jax")
    assert (gs.code_name, gs.n, gs.k, gs.frames) == (jgs.code_name, jgs.n, jgs.k, jgs.frames)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == (4 if kind == "binary" else 5)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _verify(kind, d, **kw):
    if kind == "binary":
        return golden.verify_golden(toy_code(n=48, k=32, seed=1), d, device="cpu", words=4, **kw)
    if kind == "nb":
        return golden.verify_golden_nb(toy_code(n=60, k=36, seed=2).lift_to_gf256(), d,
                                       device="cpu", words=4, emax=32, **kw)
    return golden.verify_golden_rs(15, 11, d, device="cpu", words=4, **kw)


@pytest.mark.parametrize("kind", list(SETS))
def test_port_verifies_jax_sets(tmp_path, kind):
    SETS[kind][1](tmp_path)
    passed, report = _verify(kind, tmp_path)
    assert passed, report
    assert report.endswith("encode=PASSED decode=PASSED")


def test_port_verifies_jax_set_full_size(tmp_path):
    """The CLI's default code, (2000,1000), at the width of the JAX test."""
    from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code

    jax_golden.generate_golden(jax_get_code("n2000_k1000"), tmp_path, frames=2, per=0.25, seed=1)
    passed, report = golden.verify_golden(get_code("n2000_k1000"), tmp_path, device="cpu",
                                          words=4)
    assert passed, report
    assert report == "golden n2000_k1000: frames=2 encode=PASSED decode=PASSED"


def test_nb_cli_default_set_escalates(tmp_path):
    """The CLI's default GF(256) set (``golden --gf 256 --code
    n2040_k1530_gf256``: PER .2, seed 0, 4 frames), written by JAX: three
    frames keep more than 128 erasures after the 10 sweeps, so JAX's
    verifier (``hybrid_decode``, a 128-symbol bucket) reports them failed;
    the port's escalates them and decodes every frame to the oracle's
    output."""
    from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code

    jcode = jax_get_code("n2040_k1530_gf256")
    jax_golden.generate_golden_nb(jcode, tmp_path, frames=4, per=0.2, seed=0)
    passed, report = jax_golden.verify_golden_nb(jcode, tmp_path)
    assert not passed and report.endswith("encode=PASSED decode=FAILED")
    passed, report = golden.verify_golden_nb(get_code("n2040_k1530_gf256"), tmp_path,
                                             device="cpu")
    assert passed, report
    assert report == "golden-nb n2040_k1530_gf256: frames=4 encode=PASSED decode=PASSED"


@pytest.mark.parametrize("kind,mask", [("binary", 1), ("nb", 0x5A)])
def test_flipped_value_fails_encode(tmp_path, kind, mask):
    SETS[kind][1](tmp_path)
    vals = jax_native.read_vector_file(tmp_path / golden.ENC_OUT)
    vals[5] ^= mask
    jax_native.write_vector_file(tmp_path / golden.ENC_OUT, vals)
    passed, report = _verify(kind, tmp_path)
    assert not passed
    assert "encode=FAILED decode=PASSED" in report


def test_flipped_value_fails_decode(tmp_path):
    SETS["nb"][1](tmp_path)
    vals = jax_native.read_vector_file(tmp_path / golden.DEC_OUT)
    vals[7] ^= 0x5A
    jax_native.write_vector_file(tmp_path / golden.DEC_OUT, vals)
    passed, report = _verify("nb", tmp_path)
    assert not passed and "encode=PASSED decode=FAILED" in report


def test_cli_golden_rs(tmp_path, capsys):
    assert cli.main(["golden", "--rs", "15,11", "--frames", "2", "--device", "cpu",
                     "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [f"wrote 2 golden RS frames to {tmp_path}",
                   "golden-rs (15,11): frames=2 encode=PASSED decode=PASSED"]


def test_cli_golden_defaults_to_the_card():
    args = cli.parser().parse_args(["golden", "--dir", "x"])
    assert (args.device, args.code, args.symbol_words, args.frames) == ("cuda", "n2000_k1000",
                                                                         8, 4)


def test_census_cli_matches_jax(capsys):
    from ldpc_erasure_codes_tpu.utils import cli as jax_cli

    assert cli.main(["census", "--code", "n2040_k1530"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["census", "--code", "n2040_k1530"]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("n2040_k1530: 4-cycles=0 6-cycles=")


def _strip_seconds(text: str) -> str:
    head, _, tail = text.partition(" in ")
    return head + tail[tail.index("s;"):]


@pytest.mark.parametrize("argv", [
    ["--kind", "col", "--profile-c", "51x4", "--profile-v", "102x2", "--seed", "9"],
    ["--kind", "col", "--profile-c", "51x4", "--profile-v", "102x2", "--seed", "11",
     "--non-systematic", "--max-tries", "120"],
])
def test_gen_cli_matches_jax(tmp_path, capsys, argv):
    """``gen`` prints JAX's lines (the build seconds aside) and writes a
    code that JAX's ``load_code`` reads back equal to JAX's own."""
    from ldpc_erasure_codes_tpu.utils import cli as jax_cli

    port_out, jax_out = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    assert cli.main(["gen", *argv, "--out", port_out]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["gen", *argv, "--out", jax_out]) == 0
    want = capsys.readouterr().out.splitlines()
    assert _strip_seconds(got[0]) == _strip_seconds(want[0])
    assert got[1:] == [f"saved to {port_out}"] and want[1:] == [f"saved to {jax_out}"]
    for mine, theirs in ((jax_load_code(port_out), jax_load_code(jax_out)),
                         (load_code(port_out), load_code(jax_out))):
        assert (mine.name, mine.n, mine.k, mine.gf_order) == (
            theirs.name, theirs.n, theirs.k, theirs.gf_order)
        for f in ("vlist_idx", "vlist_len", "vlist_val"):
            np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))


def test_parse_profile_matches_jax():
    from ldpc_erasure_codes_tpu.utils import cli as jax_cli

    for s in ("102x6,30x5", "16X6", "48x2"):
        assert cli._parse_profile(s) == jax_cli._parse_profile(s)
