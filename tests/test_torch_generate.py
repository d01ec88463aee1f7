"""The port's code construction (``codes/generate.py``) and ``save_code``
against the JAX package's, on the CPU.

tests/test_generate.py is the template. The generators draw from
``np.random.default_rng(seed)`` in the same order on both sides, so the
same profiles and seed give the same code: the Vlists are compared
exactly, at the sizes the JAX tests use (and the small code of
tests/test_pallas_peel.py, which the verify battery's quick tier runs).
"""

import os

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes import generate as jgen
from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes import load_code as jax_load_code
from ldpc_erasure_codes_tpu.codes import save_code as jax_save_code
from ldpc_erasure_codes_tpu_torch import codes
from ldpc_erasure_codes_tpu_torch.codes import generate as gen
from torch_port_cases import small_jax_code


def _same_code(got, want):
    assert (got.name, got.n, got.k, got.gf_order, got.rs_n, got.rs_k) == (
        want.name, want.n, want.k, want.gf_order, want.rs_n, want.rs_k)
    for f in ("vlist_idx", "vlist_len", "vlist_val"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


def test_profiles_match_jax():
    for prof in ([(2, 5), (3, 2)], [(1, 7)], [(4, 3), (4, 3), (2, 1)]):
        np.testing.assert_array_equal(gen.expand_profile(prof), jgen.expand_profile(prof))
    assert gen.check_profiles([(10, 6)], [(20, 3)]) == jgen.check_profiles([(10, 6)], [(20, 3)])
    with pytest.raises(ValueError):
        gen.expand_profile([(2, 3), (1, 5)])  # ascending degrees
    with pytest.raises(ValueError):
        gen.gen_row_wise([(10, 4)], [(20, 3)])  # 40 != 60 edges


def test_cycle_predicate_matches_jax():
    """The incremental girth test on one random edge sequence, on both
    sides' graphs, and the census of the result."""
    rng = np.random.default_rng(1)
    g, jg = gen._Graph(40, 20), jgen._Graph(40, 20)
    for _ in range(250):
        v, c = int(rng.integers(40)), int(rng.integers(20))
        if c in g.var_checks[v]:
            continue
        pred = g.creates_short_cycle(v, c)
        assert pred == jg.creates_short_cycle(v, c), (v, c)
        if not pred:
            g.add_edge(v, c)
            jg.add_edge(v, c)
    np.testing.assert_array_equal(g.to_dense(), jg.to_dense())
    assert gen.cycle_census(g.to_dense()).girth_at_least_8


@pytest.mark.parametrize("args,kw", [
    (([(102, 6)], [(204, 3)]), dict(seed=7, max_tries=60, strict_tries=5)),
    (([(16, 6)], [(48, 2)]), dict(seed=3, max_tries=40, strict_tries=4)),
])
def test_row_wise_matches_jax(args, kw):
    got = gen.gen_row_wise(*args, **kw)
    want = small_jax_code() if kw["seed"] == 3 else jgen.gen_row_wise(*args, **kw)
    _same_code(got, want)
    assert gen.cycle_census(got).girth_at_least_8


@pytest.mark.parametrize("systematic,seed", [(True, 9), (False, 11)])
def test_column_wise_matches_jax(systematic, seed):
    kw = dict(systematic=systematic, seed=seed, max_tries=120)
    _same_code(gen.gen_column_wise([(51, 4)], [(102, 2)], **kw),
               jgen.gen_column_wise([(51, 4)], [(102, 2)], **kw))


def test_census_and_histograms_match_jax():
    """``cycle_census`` and ``weight_histograms`` on the known 4- and
    6-cycle graphs, the grid code (``grid_code``) and a shipped code."""
    h4 = np.ones((2, 2), np.uint8)
    h6 = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], dtype=np.uint8)
    grid, jgrid = gen.grid_code(10, 5), jgen.grid_code(10, 5)
    _same_code(grid, jgrid)
    for h, jh in ((h4, h4), (h6, h6), (grid, jgrid),
                  (codes.get_code("n4000_k2000"), jax_get_code("n4000_k2000"))):
        got, want = gen.cycle_census(h), jgen.cycle_census(jh)
        for f in ("num_4", "num_6", "num_8"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert got.totals() == want.totals()
        assert got.girth_at_least_8 == want.girth_at_least_8
        for a, b in zip(gen.weight_histograms(h), jgen.weight_histograms(jh)):
            np.testing.assert_array_equal(a, b)
    assert gen.cycle_census(codes.get_code("n4000_k2000")).totals()[:2] == (0, 6)


def test_save_code_round_trips_both_ways(tmp_path):
    """The port's archive loads in the JAX package and JAX's in the port,
    for a shipped binary code, its GF(256) lift and a generated code."""
    for name in ("n2040_k1530", "n2000_k1000_gf256"):
        port, jax_code = codes.get_code(name), jax_get_code(name)
        p1, p2 = os.path.join(tmp_path, f"{name}_p.npz"), os.path.join(tmp_path, f"{name}_j.npz")
        codes.save_code(port, p1)
        _same_code(jax_load_code(p1), jax_code)
        jax_save_code(jax_code, p2)
        _same_code(codes.load_code(p2), port)
    grid = gen.grid_code(4, 3)
    path = os.path.join(tmp_path, "grid.npz")
    codes.save_code(grid, path)
    _same_code(codes.load_code(path), jgen.grid_code(4, 3))


def test_validate_raises_on_a_bad_code():
    grid = gen.grid_code(4, 3)
    grid.validate()
    idx = grid.vlist_idx.copy()
    idx[0, 1] = idx[0, 0]
    bad = codes.from_vlist("bad", grid.n, grid.k, idx, grid.vlist_len, grid.vlist_val)
    with pytest.raises(ValueError, match="duplicate"):
        bad.validate()
