"""The port's public API against the JAX package's.

Every public function and class of every JAX module has a counterpart in
the port with the same parameter names (class fields), and every name a
JAX package exports is exported by the port's, apart from the entries of
``NOT_PORTED`` (each named in ROADMAP.md's "Not to port") and the names and
parameters the port spells otherwise (``RENAMED``). Then the parts of the
``ops`` API that are only knobs, each against JAX's on the same inputs:
``ge_impl`` through ``compact_ge_solve``, ``hybrid_decode`` and
``hybrid_decode_escalated`` (GF(256)'s wide-word solver, which JAX does not
have, also against the benchmark's plain reference); ``gf_mul_packed(prim_poly=)``;
``from_h_dense(dmax=)``; ``send_blocks(feedback=)``.
"""

import dataclasses
import functools
import importlib
import inspect
import pathlib
import re
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes.registry import from_h_dense as jax_from_h_dense
from ldpc_erasure_codes_tpu.gf.ops import gf_mul_packed as jax_gf_mul_packed
from ldpc_erasure_codes_tpu.ops import compact as jax_compact
from ldpc_erasure_codes_tpu.ops import device_arrays as jax_device_arrays
from ldpc_erasure_codes_tpu.ops import hybrid as jax_hybrid
from ldpc_erasure_codes_tpu_torch.codes.io import from_h_dense
from ldpc_erasure_codes_tpu_torch.gf.ops import gf_mul_packed
from ldpc_erasure_codes_tpu_torch.gf.tables import gf_mul_np
from ldpc_erasure_codes_tpu_torch.ops import (
    code_arrays,
    compact_ge_solve,
    encode_packed,
    hybrid_decode,
    hybrid_decode_escalated,
)
from ldpc_erasure_codes_tpu_torch.utils import profiling
from ldpc_erasure_codes_tpu_torch.utils.streaming import BlockAssembler
from ldpc_erasure_codes_tpu_torch.utils.udp import UdpReceiver, send_blocks
from torch_port_cases import random_words, small_jax_code, to_port_code, to_torch, to_words

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = "ldpc_erasure_codes_tpu", "ldpc_erasure_codes_tpu_torch"

# JAX module -> the port module that holds its counterparts (the same name
# where absent).
MODULES = {
    "codes.registry": "codes.io",
    "ops.peel": "ops.peel_jacobi",
    "ops.peel_wide": "ops.peel_jacobi",
    "ops.pallas_channel": "ops.channel",
    "ops.pallas_elim": "ops.elim",
    "ops.pallas_encode": "ops.encode",
    "ops.pallas_ge": "ops.rank",
    "ops.pallas_nbmm": "ops.nbmm",
    "ops.pallas_peel": "ops.peel",
    "ops.pallas_synd": "ops.synd",
}

# The Pallas wrappers: names are compared, arguments are not. A wrapper's
# arguments are the TPU kernel's operand layouts and launch knobs; the
# port's wrapper takes its Hopper kernel's operands, and the CPU tests hold
# the two to one function.
KERNEL_MODULES = {m for m in MODULES if m.startswith("ops.pallas_")}

# JAX name (package.module.name, or a package export package.name) -> the
# port's; "module.function(param)" -> the port's parameter.
RENAMED = {
    "ops.peel_decode": "peel_decode_jacobi",
    "ops.peel_decode_vmem": "peel_decode",
    "ops.encode_packed_vmem": "encode_packed",
    "ops.peel.peel_decode": "peel_decode_jacobi",
    "ops.pallas_peel.peel_decode_vmem": "peel_decode",
    "ops.pallas_encode.encode_packed_vmem": "encode_packed",
    "ops.pallas_ge.ge_rank_pallas": "f2_rank_check",
    "ops.pallas_synd.f2_syndrome_tiled": "syndrome_from_topo",
    # The channels draw from a torch.Generator where JAX takes a key.
    "channel.erasure.iid_erasures(key)": "generator",
    "channel.erasure.iid_erasures_per64(key)": "generator",
    "channel.erasure.gilbert_elliott_erasures(key)": "generator",
}

# Left out on purpose: the key's last name (the parameter, for a
# parameter) is named in ROADMAP.md's "Not to port".
NOT_PORTED = {
    "utils.cache": "the XLA compile cache",
    "utils.device.vmem_bytes": "TPU VMEM sizes",
    "utils.device.peel_vmem_budget": "TPU VMEM sizes",
    "utils.device.kernel_vmem_limit": "TPU VMEM sizes",
    "ops.tile_wide": "the tile-major TPU layout",
    "ops.untile_wide": "the tile-major TPU layout",
    "ops.pallas_peel.tile_wide": "the tile-major TPU layout",
    "ops.pallas_peel.untile_wide": "the tile-major TPU layout",
    "ops.pallas_peel.default_b_tile": "the tile-major TPU layout",
    "ops.pallas_peel.static_topology": "the unrolled TPU programs' compile-time topology",
    "ops.pallas_encode.static_enc_topology": "the unrolled TPU programs' compile-time topology",
    "ops.peel.PeelState": "the lax.while_loop carry",
    "ops.arrays.CodeArrays.h_t": "derived from h where needed",
    "ops.arrays.CodeArrays.parity_gen": "the MXU encode's generator; the port encodes by rows",
    "ops.hybrid.hybrid_decode(b_tile)": "the VMEM frame tile",
    "ops.hybrid.hybrid_decode(fence_gate)": "a TPU peel knob",
    "ops.hybrid.hybrid_decode_escalated(b_tile)": "the VMEM frame tile",
    "ops.hybrid.hybrid_decode_escalated(fence_gate)": "a TPU peel knob",
    "sim.config.DecoderConfig.b_tile": "the VMEM frame tile",
    "utils.cli.make_throughput_step(b_tile)": "the VMEM frame tile",
    "utils.cli.make_throughput_step(symbol_words)": "sizes the VMEM frame tile",
    "utils.cli.make_throughput_step(tiled)": "the tile-major TPU layout",
    "utils.verify.verify_binary(bt)": "the VMEM frame tile",
    "utils.verify.verify_binary(fence_gate)": "a TPU peel knob",
    "utils.verify.verify_binary(interpret)": "the Pallas interpreter",
    "utils.verify.verify_nb(bt)": "the VMEM frame tile",
    "utils.verify.verify_nb(interpret)": "the Pallas interpreter",
    "utils.verify.verify_hybrid(bt)": "the VMEM frame tile",
    "utils.verify.verify_hybrid(interpret)": "the Pallas interpreter",
    "utils.verify.verify_rs(interpret)": "the Pallas interpreter",
    "utils.verify.run_battery(interpret)": "the Pallas interpreter",
    "utils.verify.run_battery(fence_gate)": "a TPU peel knob",
    "parallel.mesh.batch_sharding": "a JAX NamedSharding; the port has shard_batch",
    "parallel.mesh.make_mesh(devices)": "JAX device lists; torch.distributed ranks",
    "parallel.mesh.default_mesh(devices)": "JAX device lists; torch.distributed ranks",
    "parallel.multihost.initialize(kwargs)": "jax.distributed's keywords; torch.distributed's",
}


def _modules() -> list[str]:
    """The JAX package's modules, relative to it ("" is the package)."""
    base = ROOT / JAX
    out = []
    for p in sorted(base.rglob("*.py")):
        parts = p.relative_to(base).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def _import(pkg: str, rel: str):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _key(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _params(fn) -> list[str]:
    return list(inspect.signature(inspect.unwrap(fn)).parameters)


def _fields(cls) -> list[str]:
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(getattr(cls, "_fields", ()))


def _public(mod) -> dict:
    """The functions and classes a module defines, by name."""
    out = {}
    for name, obj in vars(mod).items():
        target = inspect.unwrap(obj) if callable(obj) else obj
        if (not name.startswith("_") and (inspect.isfunction(target) or inspect.isclass(target))
                and getattr(target, "__module__", None) == mod.__name__):
            out[name] = obj
    return out


@pytest.mark.parametrize("rel", _modules())
def test_module_has_counterparts(rel):
    """Each public function (its parameters) and class (its fields) of the
    JAX module has its counterpart in the port."""
    if rel in NOT_PORTED:
        with pytest.raises(ImportError):
            _import(PORT, MODULES.get(rel, rel))
        return
    jmod, pmod = _import(JAX, rel), _import(PORT, MODULES.get(rel, rel))
    missing = []
    for name, obj in _public(jmod).items():
        key = _key(rel, name)
        if key in NOT_PORTED:
            assert not hasattr(pmod, name), f"{key} is ported: drop it from NOT_PORTED"
            continue
        port = getattr(pmod, RENAMED.get(key, name), None)
        if port is None:
            missing.append(key)
            continue
        if inspect.isclass(obj):
            have = _fields(port)
            missing += [f"{key}.{f}" for f in _fields(obj)
                        if f"{key}.{f}" not in NOT_PORTED and f not in have]
            continue
        if rel in KERNEL_MODULES:
            continue
        have = _params(port)
        for p in _params(obj):
            pkey = f"{key}({p})"
            if pkey not in NOT_PORTED and RENAMED.get(pkey, p) not in have:
                missing.append(pkey)
    assert not missing, f"no counterpart in {PORT}: {missing}"


@pytest.mark.parametrize("rel", [m for m in _modules() if (ROOT / JAX / m.replace(".", "/")).is_dir()])
def test_package_exports(rel):
    """Every name a JAX package exports is exported by the port's."""
    jmod, pmod = _import(JAX, rel), _import(PORT, rel)
    names = getattr(jmod, "__all__", [n for n in vars(jmod) if not n.startswith("_")])
    missing = [n for n in names if _key(rel, n) not in NOT_PORTED
               and not hasattr(pmod, RENAMED.get(_key(rel, n), n))]
    assert not missing, f"{PORT}.{rel} does not export {missing}"


def _not_to_port() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not to port.**")
    return text[start:text.index("\n### ", start)]


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_is_in_roadmap_and_jax(key):
    """Each entry names a JAX module, function, class field or parameter,
    and ROADMAP.md's "Not to port" names it."""
    base, _, param = key.partition("(")
    param = param.rstrip(")")
    parts = base.split(".")
    i = max(j for j in range(len(parts) + 1) if ".".join(parts[:j]) in _modules())
    obj = _import(JAX, ".".join(parts[:i]))
    for part in parts[i:]:
        if inspect.isclass(obj):
            assert part in _fields(obj), key
        else:
            obj = getattr(obj, part)
    if param:
        assert param in _params(obj), key
    assert re.search(rf"\b{param or parts[-1]}\b", _not_to_port()), key


# -- ge_impl ---------------------------------------------------------------


@functools.cache
def _codes(field: int):
    jcode = small_jax_code()
    code = to_port_code(jcode)
    if field == 256:
        jcode, code = jcode.lift_to_gf256(seed=0), code.lift_to_gf256(seed=0)
    return jax_device_arrays(jcode), code_arrays(code, "cpu")


def _wide(field: int, b: int, per: float, seed: int):
    """(codewords, mask, received): wide frames, 3 words (binary) or 8 bytes
    (GF(256)), as NumPy."""
    _, arrays = _codes(field)
    k = arrays.n - arrays.m
    rng = np.random.default_rng(seed)
    if field == 2:
        cw = to_words(encode_packed(arrays, to_torch(random_words(rng, (b, k, 3)))))
    else:
        src = torch.from_numpy(rng.integers(0, 256, (b, k, 8), dtype=np.uint8))
        cw = encode_packed(arrays, src, gf_order=256).numpy()
    mask = rng.random((b, arrays.n)) < per
    return cw, mask, np.where(mask[:, :, None], 0, cw)


def _port(x: np.ndarray) -> torch.Tensor:
    return to_torch(x) if x.dtype == np.uint32 else torch.from_numpy(x)


def _np(t: torch.Tensor) -> np.ndarray:
    return to_words(t) if t.dtype == torch.int32 else t.numpy()


def _same_unfailed(got, want, failed_at: int) -> None:
    """Every output equal, the values only on frames that did not fail."""
    got = [_np(g) if isinstance(g, torch.Tensor) else g for g in got]
    want = [np.asarray(w) if not isinstance(w, int) else w for w in want]
    ok = ~want[failed_at]
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    for g, w in zip(got[1:], want[1:], strict=True):
        np.testing.assert_array_equal(g, w)


GE_CASES = [(2, "auto"), (2, "packed"), (2, "bytes"), (256, "auto"), (256, "bytes"),
            (256, "packed")]


def _jax_impl(field: int, ge_impl: str) -> str:
    """JAX's ``ge_impl`` to hold the port's against: JAX solves GF(256)
    bytes with its byte solver ("auto", "bytes"; its "packed" runs the
    binary solver on them), and the port's "auto" and "packed" with
    GF(256)'s wide-word solver, which returns what the byte solver does."""
    return "bytes" if field == 256 else ge_impl


@pytest.mark.parametrize("field,ge_impl", GE_CASES)
def test_compact_ge_solve_ge_impl_matches_jax(field, ge_impl):
    jarr, arrays = _codes(field)
    cw, mask, recv = _wide(field, 12, 0.3, 1)
    kw = dict(emax=14, f_max=7, gf_order=field)
    want = jax_compact.compact_ge_solve(jarr, jnp.asarray(recv), jnp.asarray(mask), **kw,
                                        ge_impl=_jax_impl(field, ge_impl))
    got = compact_ge_solve(arrays, _port(recv), torch.from_numpy(mask), **kw, ge_impl=ge_impl)
    _same_unfailed(got, want, 2)
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()


@pytest.mark.parametrize("ge_subbatch", [0, 5])
@pytest.mark.parametrize("field,ge_impl", GE_CASES)
def test_hybrid_ge_impl_matches_jax(field, ge_impl, ge_subbatch):
    jarr, arrays = _codes(field)
    cw, mask, recv = _wide(field, 12, 0.3, 2)
    kw = dict(gf_order=field, peel_iters=2, emax=12, ge_subbatch=ge_subbatch)
    want = jax_hybrid.hybrid_decode(jarr, jnp.asarray(recv), jnp.asarray(mask),
                                    return_overflow=True, **kw, ge_impl=_jax_impl(field, ge_impl))
    got = hybrid_decode(arrays, _port(cw), torch.from_numpy(mask), return_overflow=True, **kw,
                        ge_impl=ge_impl)
    _same_unfailed(got, want, 3)


@pytest.mark.parametrize("field,ge_impl", GE_CASES)
def test_escalated_ge_impl_matches_jax(field, ge_impl):
    """emax 6 overflows most frames; the escalation solves them again."""
    jarr, arrays = _codes(field)
    cw, mask, recv = _wide(field, 12, 0.3, 3)
    kw = dict(gf_order=field, peel_iters=2, emax=6, ge_subbatch=4)
    want = jax_hybrid.hybrid_decode_escalated(jarr, jnp.asarray(recv), jnp.asarray(mask), **kw,
                                              ge_impl=_jax_impl(field, ge_impl))
    got = hybrid_decode_escalated(arrays, _port(cw), torch.from_numpy(mask), **kw,
                                  ge_impl=ge_impl)
    _same_unfailed(got, want, 3)
    assert got[4] > 0


@pytest.mark.parametrize("ge_impl", ["auto", "packed"])
def test_escalated_gf256_packed_matches_the_benchmark_reference(ge_impl):
    """GF(256)'s wide-word solver ("auto" and "packed" alike) through both
    dispatches, against the benchmark's
    own reference (``codec_bench/reference``, which takes nothing of the
    program but the lift's Vlist and coefficients): every symbol a frame
    delivers is its codeword's, and a frame fails exactly where the erased
    columns of H are dependent over GF(256)."""
    from codec_bench.reference import codes as ref_codes
    from codec_bench.reference import recovery

    code = to_port_code(small_jax_code()).lift_to_gf256(seed=0)
    _, arrays = _codes(256)
    gf = ref_codes.GF256.frozen()
    idx = code.vlist_idx.astype(np.int64)
    h_nb = ref_codes.parity_check(code.n, idx, code.vlist_val)
    p = ref_codes.ldpc_parity_gf256(h_nb, code.k, gf)
    ref = ref_codes.Code(code.n, code.k, ref_codes.binary_image(p, gf), 8, vlist=idx, h_nb=h_nb)
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(-(2**31), 2**31, (48, code.k, 2), dtype=np.int32))
    cw = ref.codewords(src)
    assert torch.equal(cw.view(torch.uint8),
                       encode_packed(arrays, src.view(torch.uint8), gf_order=256))
    mask = torch.from_numpy(rng.random((48, code.n)) < 0.33)
    recv = cw.masked_fill(mask[:, :, None], 0).view(torch.uint8)
    profiling.reset()
    with profiling.recording():
        values, erased, _, failed, n_esc = hybrid_decode_escalated(
            arrays, recv, mask, gf_order=256, peel_iters=2, emax=8, ge_subbatch=16,
            ge_impl=ge_impl)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    ok = recovery.ml_rank(ref, mask)
    assert torch.equal(failed, ~ok) and ok.any() and not ok.all()
    assert n_esc > 0 and counters["hybrid.ge.nb_wide_frames"] == 16
    known = ~erased
    assert not erased[ok].any() and torch.equal(erased, erased & mask)
    assert torch.equal(values.view(torch.int32)[known], cw[known])


@pytest.mark.parametrize("field,w,ge_impl", [(256, 0, "packed"), (2, 0, "packed"),
                                             (2, 3, "bogus")])
def test_ge_impl_refusals(field, w, ge_impl):
    """"packed" on scalar (B, n) frames of either field and an unknown
    ge_impl raise."""
    _, arrays = _codes(field)
    cw, mask, _ = _wide(field, 4, 0.3, 4)
    values = _port(cw)
    if w == 0:
        scalar = cw[:, :, 0] if field == 256 else to_words(values)[:, :, 0] & 1
        values = torch.from_numpy(np.ascontiguousarray(scalar).astype(np.uint8))
    with pytest.raises(ValueError):
        hybrid_decode(arrays, values, torch.from_numpy(mask), gf_order=field, ge_impl=ge_impl)
    with pytest.raises(ValueError):
        compact_ge_solve(arrays, values, torch.from_numpy(mask), emax=8, f_max=2,
                         gf_order=field, ge_impl=ge_impl)


# -- the other knobs --------------------------------------------------------


@pytest.mark.parametrize("prim_poly", [0x11D, 0x171])
def test_gf_mul_packed_prim_poly_matches_jax(prim_poly):
    """Every byte times every coefficient in the field of ``prim_poly``, for
    tensor and Python-int coefficients; 0x11D differs from the default."""
    words = np.arange(256, dtype=np.uint8).reshape(64, 4).view(np.uint32)[:, 0]
    coef = np.arange(256, dtype=np.uint32)
    want = np.asarray(jax_gf_mul_packed(jnp.asarray(words)[None, :], jnp.asarray(coef)[:, None],
                                        prim_poly))
    got = gf_mul_packed(to_torch(words)[None, :], torch.from_numpy(coef.astype(np.int32))[:, None],
                        prim_poly)
    np.testing.assert_array_equal(to_words(got), want)
    for c in (0, 1, 2, 0x8E, 255):
        np.testing.assert_array_equal(to_words(gf_mul_packed(to_torch(words), c, prim_poly)),
                                      want[c])
    default = prim_poly == 0x171
    assert np.array_equal(want.view(np.uint8).reshape(256, 256)[:, :],
                          gf_mul_np(*np.meshgrid(np.arange(256, dtype=np.uint8),
                                                 np.arange(256, dtype=np.uint8)))) == default


@pytest.mark.parametrize("dmax", [None, 9])
def test_from_h_dense_dmax_matches_jax(dmax):
    h = np.random.default_rng(5).integers(0, 4, (6, 14)) * (np.random.default_rng(6).random(
        (6, 14)) < 0.4)
    h[np.arange(6), 8 + np.arange(6)] = 1
    want, got = jax_from_h_dense(h, "t", dmax=dmax), from_h_dense(h, "t", dmax=dmax)
    for f in ("n", "k", "gf_order", "vlist_idx", "vlist_len", "vlist_val"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.vlist_idx.shape[1] == (dmax or int((h != 0).sum(axis=1).max()))
    with pytest.raises(ValueError):
        from_h_dense(h, "t", dmax=1)


def test_send_blocks_feedback_polls_the_count():
    """JAX's flow control: ``feedback()`` is the receiver's drained count;
    every datagram arrives; ``wait`` and ``feedback`` together raise."""
    blocks = np.random.default_rng(3).integers(0, 256, (2, 7, 4), dtype=np.uint8)
    rx = UdpReceiver(BlockAssembler(7, 4, 4, max_blocks=2, decode_at_k=False))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    polls = []

    def feedback():
        polls.append(rx.datagrams)
        return rx.datagrams

    try:
        sent = send_blocks(tx, rx.addr, blocks, window=3, feedback=feedback)
        assert rx.wait_for(sent, timeout=10.0)
        with pytest.raises(ValueError):
            send_blocks(tx, rx.addr, blocks, window=3, feedback=feedback, wait=rx.wait_for)
    finally:
        tx.close()
        rx.close()
    assert sent == 14 and len(polls) >= 5 and polls[0] == 0
