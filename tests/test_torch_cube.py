"""The cube kernel's plain version and the GE's CPU path, on the CPU.

``ops/cube.py::f2_cube_reference`` (the order of ``csrc/cube.cu``: a slot
table of the erased symbols, then each row of H over its Vlist neighbours)
against ``erased_indices`` + ``coefficient_cube``, the plain path it
replaces on the card, on the toy code and on (2040,1530) at small B, edge
masks included. ``ge_solve_packed`` keeps that plain path for CPU tensors.
Everything is integer work: equality is exact. No JAX here.
"""

import functools

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops import cube as cube_mod
from ldpc_erasure_codes_tpu_torch.ops import ge as ge_mod
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
from ldpc_erasure_codes_tpu_torch.ops.ge import (
    coefficient_cube,
    erased_indices,
    ge_rank_check_reference,
    ge_solve_packed,
)
from torch_port_cases import cube_edge_masks, random_words, to_torch


@functools.cache
def _arrays(name: str):
    code = toy_code() if name == "toy" else get_code(name)
    return code, code_arrays(code, "cpu")


def _plain(arrays, erased, emax):
    er_idx, real, nreal = erased_indices(erased, emax)
    return er_idx, nreal, coefficient_cube(arrays, er_idx, real)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name,emax", [
    ("toy", 1), ("toy", 16), ("toy", 31), ("toy", 32), ("toy", 33), ("toy", 48), ("toy", 100),
    ("n2040_k1530", 384), ("n2040_k1530", 512),
])
def test_cube_reference_matches_plain_path_on_edge_masks(name, emax):
    """None erased, all erased, word edges, the bucket one short, full and
    one over (its cube words and its pad slots too), one random frame; an
    emax past n is clamped."""
    _, arrays = _arrays(name)
    erased = cube_edge_masks(arrays.n, emax, emax)
    got = cube_mod.f2_cube_reference(arrays, erased, emax=emax)
    _assert_same(got, _plain(arrays, erased, emax))
    assert got[0].shape == (erased.shape[0], min(emax, arrays.n))


@pytest.mark.parametrize("name,b,per,emax", [
    ("toy", 16, 0.3, 24), ("n2040_k1530", 8, 0.2031, 512), ("n2040_k1530", 8, 0.25, 384),
])
def test_cube_reference_matches_plain_path_on_random_masks(name, b, per, emax):
    _, arrays = _arrays(name)
    erased = torch.from_numpy(np.random.default_rng(b).random((b, arrays.n)) < per)
    _assert_same(cube_mod.f2_cube_reference(arrays, erased, emax=emax),
                 _plain(arrays, erased, emax))


@pytest.mark.parametrize("emax", [1, 16])
def test_cube_empty_batch(emax):
    """B = 0 gives empty outputs, B = 3 frames with nothing erased the
    identity beside zero A words."""
    _, arrays = _arrays("toy")
    for b in (0, 3):
        erased = torch.zeros((b, arrays.n), dtype=torch.bool)
        got = cube_mod.f2_cube(arrays, erased, emax=emax)
        _assert_same(got, _plain(arrays, erased, emax))
        assert got[2].shape == (b, arrays.m, -(-emax // 32) + -(-arrays.m // 32))


def test_cube_wrapper_takes_the_reference_on_the_cpu():
    _, arrays = _arrays("toy")
    erased = cube_edge_masks(arrays.n, 16, 1)
    before = cube_mod.f2_cube.launches
    _assert_same(cube_mod.f2_cube(arrays, erased, emax=16),
                 cube_mod.f2_cube_reference(arrays, erased, emax=16))
    assert cube_mod.f2_cube.launches == before
    with pytest.raises(ValueError):
        cube_mod.f2_cube(arrays, erased[:, :-1], emax=16)
    with pytest.raises(ValueError):
        cube_mod.f2_cube(arrays, erased, emax=-1)


@pytest.mark.parametrize("name,emax,return_rows", [
    ("toy", 16, False), ("toy", 16, True), ("n2040_k1530", 512, False),
])
def test_ge_solve_packed_cpu_path_keeps_the_plain_cube(monkeypatch, name, emax, return_rows):
    """CPU tensors never reach the cube wrapper; solved frames deliver the
    codeword, and the failures are the rank check's (or the bucket's): the
    frame with nothing erased is solved, the one with everything erased
    fails."""
    code, arrays = _arrays(name)

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path called f2_cube")

    monkeypatch.setattr(ge_mod, "f2_cube", refuse)
    rng = np.random.default_rng(emax)
    cw = encode_packed(arrays, to_torch(random_words(rng, (6, code.k, 3))))
    erased = cube_edge_masks(arrays.n, emax, 2)[: 6]
    erased[5] = torch.from_numpy(rng.random(arrays.n) < 0.15)
    values = cw.masked_fill(erased[:, :, None], 0)
    out = ge_solve_packed(arrays, values, erased, emax=emax, return_rows=return_rows)
    failed = out[-1]
    torch.testing.assert_close(failed, ge_rank_check_reference(arrays, erased, emax=emax),
                               rtol=0, atol=0)
    assert not failed[0] and failed[1]
    if return_rows:
        x, sidx = out[0], out[1]
        for f in torch.nonzero(~failed).flatten().tolist():
            keep = sidx[f] < arrays.n
            torch.testing.assert_close(x[f][keep], cw[f][sidx[f][keep].long()], rtol=0, atol=0)
    else:
        ok = ~failed
        torch.testing.assert_close(out[0][ok], cw[ok], rtol=0, atol=0)
        assert not out[1][ok].any() and torch.equal(out[1][~ok], erased[~ok])
