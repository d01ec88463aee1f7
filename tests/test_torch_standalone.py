"""The port stands alone: its own copy of the shipped codes, and a run with
the JAX package absent.

The first case holds the port's ``data/codes/*.npz`` byte for byte to the
JAX package's. The second copies ``ldpc_erasure_codes_tpu_torch/`` (no
``build/``, no ``__pycache__/``) into a fresh directory and runs it there in
a child process whose import system refuses ``jax``, ``jaxlib`` and
``ldpc_erasure_codes_tpu``: every module of the port is imported, the
shipped codes are loaded, and a small seeded batch is encoded and peeled on
the CPU. Its digest must equal the one this process computes with the
repo's own port.
"""

import hashlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import textwrap

import ldpc_erasure_codes_tpu_torch

PKG = os.path.dirname(os.path.abspath(ldpc_erasure_codes_tpu_torch.__file__))
JAX_CODES = os.path.join(os.path.dirname(PKG), "ldpc_erasure_codes_tpu", "data", "codes")
PORT_CODES = os.path.join(PKG, "data", "codes")
BLOCKED = ("jax", "jaxlib", "ldpc_erasure_codes_tpu")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_codes_are_byte_identical_to_jax():
    names = sorted(f for f in os.listdir(PORT_CODES) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(JAX_CODES) if f.endswith(".npz"))
    assert len(names) == 4
    for f in names:
        assert _sha256(os.path.join(PORT_CODES, f)) == _sha256(os.path.join(JAX_CODES, f)), f


def _digest():
    """sha256 of a B=4, W=2 seeded batch of (2040,1530) encoded and peeled at
    PER .1406 on the CPU (decoded values, erasures, iteration counts), after
    loading the shipped codes and the binary code's arrays."""
    import hashlib

    import numpy as np
    import torch

    from ldpc_erasure_codes_tpu_torch.codes.io import DATA_DIR, get_code, list_codes
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
    from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode

    names = list_codes()
    assert names == ["n2000_k1000", "n2040_k1530", "n4000_k2000", "n4080_k3060"], (
        f"list_codes() is {names} in {DATA_DIR}")
    code = get_code("n2040_k1530")
    nb = get_code("n2040_k1530_gf256")
    assert (nb.n, nb.k, nb.gf_order) == (code.n, code.k, 256)
    arrays = code_arrays(code, "cpu")
    rng = np.random.default_rng(0)
    src = rng.integers(-(2**31), 2**31, (4, code.k, 2), dtype=np.int64).astype(np.int32)
    cw = encode_packed(arrays, torch.from_numpy(src))
    mask = torch.from_numpy(np.random.default_rng(1).random((4, code.n)) < 0.1406)
    values, erased, iters = peel_decode(arrays, cw.masked_fill(mask[:, :, None], 0), mask)
    h = hashlib.sha256()
    for t in (values, erased, iters):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


CHILD = """
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in {blocked!r}:
            raise ImportError("refused in the standalone run: " + name)
        return None

sys.meta_path.insert(0, _Refuse())

import importlib
import json
import pkgutil

import ldpc_erasure_codes_tpu_torch as pkg

def _raise(name):
    raise ImportError("walk_packages could not import " + name)

mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".", onerror=_raise)]
for name in mods:
    importlib.import_module(name)

{digest}
d = _digest()
bad = sorted(m for m in sys.modules if m.partition(".")[0] in {blocked!r})
assert not bad, bad
print(json.dumps({{"file": pkg.__file__, "modules": len(mods), "digest": d}}))
"""


def test_port_runs_without_the_jax_package(tmp_path):
    shutil.copytree(PKG, tmp_path / "ldpc_erasure_codes_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = CHILD.format(blocked=BLOCKED, digest=textwrap.dedent(inspect.getsource(_digest)))
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", src], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["file"].startswith(str(tmp_path)), out["file"]
    assert out["modules"] >= 40
    assert out["digest"] == _digest()
