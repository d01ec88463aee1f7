"""The port's main path as a whole: encode -> channel mask -> peel -> verify.

Held against the JAX chain ``encode_packed_vmem`` -> mask ->
``peel_decode_vmem`` (production schedule: unrolled, fence gate) on the
same NumPy source and mask. Also guards the port's independence from JAX:
it must import and run with ``jax`` unimportable.
"""

import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_encode import encode_packed_vmem
from ldpc_erasure_codes_tpu.ops.pallas_peel import peel_decode_vmem, static_topology
from ldpc_erasure_codes_tpu_torch.channel.erasure import apply_erasures, iid_erasures
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode
from ldpc_erasure_codes_tpu_torch.utils.verify import check_peel
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ldpc_erasure_codes_tpu_torch")


def _port_chain(src, mask, k):
    arrays = code_arrays(to_port_code(small_jax_code()), "cpu")
    cw = encode_packed(arrays, to_torch(src))
    m = torch.from_numpy(mask)
    v, e, it = peel_decode(arrays, cw, m, max_iters=50, early_stop_k=k)
    report = check_peel(arrays, cw, m, v, e, it, max_iters=50, early_stop_k=k)
    return arrays, cw, m, (v, e, it), report


def test_chain_matches_jax_chain():
    jcode = small_jax_code()
    k = jcode.k
    rng = np.random.default_rng(11)
    src = random_words(rng, (8, k, 2))
    mask = rng.random((8, jcode.n)) < 0.2
    jarr = device_arrays(jcode)
    jcw = encode_packed_vmem(jarr, jnp.asarray(src), b_tile=4, interpret=True)
    jv, je, ji = (
        np.asarray(x)
        for x in peel_decode_vmem(
            jarr, jcw, jnp.asarray(mask), max_iters=50, early_stop_k=k, b_tile=4,
            schedule="unrolled", static_topo=static_topology(jarr), fence_gate=True,
            unroll_blk=4, interpret=True,
        )
    )
    _, cw, _, (v, e, it), report = _port_chain(src, mask, k)
    assert report["ok"], report
    np.testing.assert_array_equal(to_words(cw), np.asarray(jcw))
    pv, pe = to_words(v), e.numpy()
    np.testing.assert_array_equal(it.numpy(), ji)
    np.testing.assert_array_equal(pe[:, :k], je[:, :k])
    both = ~pe & ~je
    np.testing.assert_array_equal(pv[both], jv[both])
    assert (ji < 50).any() and (ji == 50).any()  # decoded and stuck frames both occur


def test_verify_catches_each_fault():
    jcode = small_jax_code()
    rng = np.random.default_rng(12)
    src = random_words(rng, (4, jcode.k, 2))
    mask = rng.random((4, jcode.n)) < 0.3
    arrays, cw, m, (v, e, it), report = _port_chain(src, mask, None)
    assert report["ok"], report
    kw = dict(max_iters=50, early_stop_k=None)
    r, c = map(int, np.argwhere(~e.numpy())[0])
    bad_v = v.clone()
    bad_v[r, c, 1] ^= 4
    assert check_peel(arrays, cw, m, bad_v, e, it, **kw)["value_mismatches"] == 1
    stuck = np.argwhere(e.numpy())
    assert len(stuck)
    bad_v = v.clone()
    bad_v[tuple(stuck[0])] = 9
    assert check_peel(arrays, cw, m, bad_v, e, it, **kw)["erased_nonzero"] == 2
    bad_e = e.clone()
    bad_e[r, c] = True
    got = check_peel(arrays, cw, m, v, bad_e, it, **kw)
    assert got["erased_outside_channel"] + got["ref_mask_mismatches"] >= 1 and not got["ok"]
    assert check_peel(arrays, cw, m, v, e, it + 1, **kw)["ref_iter_mismatches"] == 4


def test_runs_with_jax_unimportable():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "import ldpc_erasure_codes_tpu_torch as p\n"
        "code = p.get_code('n2000_k1000')\n"
        "arrays = p.code_arrays(code, 'cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "src = torch.randint(-2**31, 2**31, (2, code.k, 2), dtype=torch.int32, generator=g)\n"
        "cw = p.encode_packed(arrays, src)\n"
        "mask = p.iid_erasures((2, code.n), 0.3, generator=g, device='cpu')\n"
        "v, e, it = p.peel_decode(arrays, cw, mask, early_stop_k=code.k)\n"
        "assert (v[~e] == cw[~e]).all() and not v[e].any()\n"
        "mask = p.iid_erasures((2, code.n), 0.44, generator=g, device='cpu')\n"
        "assert p.peel_decode(arrays, cw, mask, max_iters=10)[1].any()\n"
        "hv, he, hit, hf = p.hybrid_decode(arrays, cw, mask, emax=1000, ge_subbatch=2,\n"
        "                                  tiled=True, static_topo=True, impl='vmem')\n"
        "assert not hf.all() and not he[~hf].any() and (hv[~hf] == cw[~hf]).all()\n"
        "assert not [m for m in sys.modules if m.startswith('ldpc_erasure_codes_tpu.')]\n"
        "print('ok', it.tolist())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _package_sources():
    """chip_smoke.py and every Python file of the package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, subdirs, fs in os.walk(PKG):
        subdirs[:] = [s for s in subdirs if s != "build"]  # build outputs, not source
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 10
    return files


def test_package_source_never_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ldpc_erasure_codes_tpu)\b(?!_torch)", re.M)
    for path in _package_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_package_source_never_imports_a_bench_module():
    """Measurement lives outside the package (codec_bench/): nothing in it
    or in chip_smoke.py imports a ``bench`` module of the package."""
    pat = re.compile(
        r"^\s*(import\s+ldpc_erasure_codes_tpu_torch\.bench\b"
        r"|from\s+ldpc_erasure_codes_tpu_torch\.bench\b"
        r"|from\s+ldpc_erasure_codes_tpu_torch\s+import\s+(\([^)]*|[^\n]*)\bbench\b)", re.M)
    assert not os.path.exists(os.path.join(PKG, "bench.py"))
    for path in _package_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_channel_matches_jax_and_draws_the_rate():
    from ldpc_erasure_codes_tpu.channel import apply_erasures as jax_apply_erasures

    rng = np.random.default_rng(13)
    vals = random_words(rng, (3, 50, 4))
    mask = rng.random((3, 50)) < 0.3
    want = np.asarray(jax_apply_erasures(jnp.asarray(vals), jnp.asarray(mask)))
    got = apply_erasures(to_torch(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(to_words(got), want)
    got_2d = apply_erasures(to_torch(vals[:, :, 0]), torch.from_numpy(mask))
    np.testing.assert_array_equal(to_words(got_2d), want[:, :, 0])

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return iid_erasures((64, 2040), 0.1406, generator=g, device="cpu")

    m = draw(1)
    assert m.dtype == torch.bool and m.shape == (64, 2040)
    assert torch.equal(m, draw(1)) and not torch.equal(m, draw(2))
    # 130560 Bernoulli(0.1406) draws: the standard error of the rate is 0.001.
    assert abs(float(m.float().mean()) - 0.1406) < 0.005
    g = torch.Generator().manual_seed(0)
    assert iid_erasures((2, 3), 1.0, generator=g, device="cpu").all()
    assert not iid_erasures((2, 3), -1.0, generator=g, device="cpu").any()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {"ldpc_encode_launch", "ldpc_peel_launch", "ldpc_elim_launch", "ldpc_synd_launch",
            "ldpc_f2_matvec_launch", "ldpc_f2_matmul_launch", "ldpc_f2_apply_rows_launch"} <= set(
        _build.LAUNCHERS)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    first = _build.library_path()
    assert first == _build.library_path()
    (csrc / "words.cuh").write_text((csrc / "words.cuh").read_text() + "\n")
    assert _build.library_path() != first


def test_build_compiles_each_source_in_parallel_then_links(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu, all started before any is waited on, then
    one link; objects are removed and the library lands under its hash."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(repr(sys.argv[1:]) + '\\n')\n"
        "time.sleep(0.5 if '-c' in sys.argv else 0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('x')\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path, seconds = _build.build()
    calls = [eval(line) for line in log.read_text().splitlines()]
    srcs = _build.sources()
    assert {"elim.cu", "synd.cu", "f2mm.cu", "peel.cu", "encode.cu"} <= {
        os.path.basename(x) for x in srcs
    }
    compiles = [c for c in calls if "-c" in c]
    assert sorted(c[-1] for c in compiles) == sorted(srcs)
    assert calls[-1][: len(_build.LINK_FLAGS)] == list(_build.LINK_FLAGS)
    assert seconds < 0.5 * len(srcs)  # the compiles overlapped
    assert os.path.exists(path) and path == _build.library_path()
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), os.path.basename(path)[: -len(".so")] + ".log"]
    )
    assert _build.build() == (path, 0.0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without a CUDA card, or run from a directory that holds nothing but
    the script, chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA card is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
