"""The port's GF(2) rank check against the JAX package's, on the CPU.

The same residual masks (made with NumPy, peeled by the port's plain
pattern-only peel) go to JAX ``ge_rank_check``, JAX ``ge_rank_pallas`` in
interpret mode (as tests/test_pallas_channel.py runs it), the port's
``ge_rank_check`` (its plain pivot loop on CPU tensors) and the plain
version of the rank kernel, ``f2_rank_check_reference``. The flags are
integer results: equality is exact. Every case holds frames that pass,
frames that are rank deficient and frames that overflow the column bucket.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes.toy import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu.ops import compact as jax_compact
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops import ge as jax_ge
from ldpc_erasure_codes_tpu.ops.pallas_ge import ge_rank_pallas
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.codes.toy import toy_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays, unpack_bits
from ldpc_erasure_codes_tpu_torch.ops.compact import compact_ge_rank
from ldpc_erasure_codes_tpu_torch.ops.encode import encode
from ldpc_erasure_codes_tpu_torch.ops.ge import ge_rank_check, ge_rank_check_reference
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_mask
from ldpc_erasure_codes_tpu_torch.ops.rank import (
    erased_columns,
    f2_rank_check,
    f2_rank_check_reference,
)
from torch_port_cases import rank_edge_masks


def _residuals(arrays, n, pers, frames_per, seed):
    """Peeled (to convergence) i.i.d. masks, ``frames_per`` frames at each
    PER of ``pers``: (B, n) bool."""
    rng = np.random.default_rng(seed)
    mask = np.concatenate([rng.random((frames_per, n)) < p for p in pers])
    e, _ = peel_decode_mask(arrays, torch.from_numpy(mask), max_iters=200)
    return e


def _codeword_supports(arrays, k, count, max_weight, seed):
    """Erasure patterns on the supports of codewords with one source bit
    set and weight at most ``max_weight``: their columns sum to zero, so
    they are rank deficient; and the same patterns with their first symbol
    kept, which break that dependency."""
    cw = encode(arrays, torch.eye(k, dtype=torch.uint8)).bool()
    light = torch.nonzero(cw.sum(dim=1) <= max_weight)[:, 0].numpy()
    pick = np.random.default_rng(seed).choice(light, count, replace=False)
    cw = cw[torch.from_numpy(pick)]
    kept = cw.clone()
    kept[torch.arange(count), cw.to(torch.uint8).argmax(dim=1)] = False
    return torch.cat([cw, kept])


def _cases():
    small = code_arrays(toy_code(48, 32, seed=3), "cpu")
    big = code_arrays(get_code("n2040_k1530"), "cpu")
    return {
        "small": (jax_toy_code(48, 32, seed=3), small, torch.cat([
            _residuals(small, 48, (0.2, 0.35, 0.5), 6, 1),
            _codeword_supports(small, 32, 6, 12, 2),
        ])),
        "n2040_k1530": (jax_get_code("n2040_k1530"), big, torch.cat([
            _residuals(big, 2040, (0.215, 0.23, 0.26), 3, 3),
            _codeword_supports(big, 1530, 3, 60, 4),
        ])),
    }


CASES = _cases()


@pytest.mark.parametrize("name,emax", [("small", 10), ("small", 20), ("n2040_k1530", 64),
                                       ("n2040_k1530", 192)])
def test_rank_flags_match_jax(name, emax):
    jcode, arrays, e = CASES[name]
    jarrays = device_arrays(jcode)
    je = jnp.asarray(e.numpy())
    want = np.asarray(jax_ge.ge_rank_check(jarrays, je, emax=emax))
    pallas = np.asarray(ge_rank_pallas(jarrays, je, emax=min(emax, jcode.n), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(ge_rank_check(arrays, e, emax=emax).numpy(), want)
    np.testing.assert_array_equal(ge_rank_check_reference(arrays, e, emax=emax).numpy(), want)
    np.testing.assert_array_equal(f2_rank_check_reference(arrays, e, emax=emax).numpy(), want)
    np.testing.assert_array_equal(f2_rank_check(arrays, e, emax=emax).numpy(), want)
    nreal = e.sum(dim=1).numpy()
    overflow = nreal > min(emax, jcode.n)
    deficient = want & ~overflow
    assert overflow.any(), "no frame overflowed the bucket"
    assert deficient.any(), "no rank-deficient frame"
    assert (~want & (nreal > 0)).any(), "no solvable residual frame"
    assert (nreal == 0).any() or name != "small", "no frame without a residual"


@pytest.mark.parametrize("name,emax", [("small", 40), ("n2040_k1530", 128),
                                       ("n2040_k1530", 256), ("n2040_k1530", 512)])
def test_rank_edge_cases_match_jax(name, emax):
    """The card tests' edge cases (``rank_edge_masks``): no erasure, 31, 32
    and 33 erasures, emax and emax + 1, and codeword supports whose last
    column (65, 96 or emax columns in: a word's first column, a word's last,
    the last word's last) is dependent, with and without that column. Every
    route of the kernel picks the first candidate row as the pivot, the
    order of ``f2_rank_check_reference``; the flags do not depend on the
    order, and equal JAX ``ge_rank_check``'s and ``ge_rank_pallas``'s."""
    jcode, arrays, _ = CASES[name]
    e, dependent = rank_edge_masks(arrays, jcode.k, emax, 13)
    jarrays = device_arrays(jcode)
    je = jnp.asarray(e.numpy())
    want = np.asarray(jax_ge.ge_rank_check(jarrays, je, emax=emax))
    pallas = np.asarray(ge_rank_pallas(jarrays, je, emax=min(emax, jcode.n), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(f2_rank_check_reference(arrays, e, emax=emax).numpy(), want)
    np.testing.assert_array_equal(f2_rank_check(arrays, e, emax=emax).numpy(), want)
    np.testing.assert_array_equal(ge_rank_check_reference(arrays, e, emax=emax).numpy(), want)
    assert not want[0] and want[5] and want[dependent.numpy()].all()
    assert dependent.numel() == (1 if name == "small" else 3)


def test_small_code_outcomes_are_the_ones_built():
    """On the small code the codeword supports are deficient and, where the
    residual is wider than m, so is every frame; emax 192 > n clamps."""
    jcode, arrays, e = CASES["small"]
    failed = f2_rank_check_reference(arrays, e, emax=192)
    supports = e[-12:-6]
    assert failed[-12:-6].all() and supports.any(dim=1).all()
    nreal = e.sum(dim=1)
    assert failed[nreal > arrays.m].all()


@pytest.mark.parametrize("f_max", [4, 16])
def test_compact_ge_rank_matches_jax(f_max):
    jcode, arrays, e = CASES["n2040_k1530"]
    jarrays = device_arrays(jcode)
    want = np.asarray(jax_compact.compact_ge_rank(jarrays, jnp.asarray(e.numpy()), emax=192,
                                                  f_max=f_max))
    got = compact_ge_rank(arrays, e, emax=192, f_max=f_max)
    np.testing.assert_array_equal(got.numpy(), want)


def test_erased_columns_are_the_erased_columns_of_h():
    _, arrays, e = CASES["small"]
    emax = 24
    cols = unpack_bits(erased_columns(arrays, e, emax))[:, :, :emax]  # (B, m, emax)
    for f in range(e.shape[0]):
        idx = torch.nonzero(e[f])[:, 0][:emax]
        want = torch.zeros((arrays.m, emax), dtype=cols.dtype)
        want[:, : idx.numel()] = arrays.h[:, idx].to(cols.dtype)
        assert torch.equal(cols[f], want), f


def test_rank_check_refuses_bad_input():
    _, arrays, e = CASES["small"]
    with pytest.raises(ValueError):
        f2_rank_check(arrays, e.to(torch.uint8), emax=8)
    with pytest.raises(ValueError):
        f2_rank_check(arrays, e[:, :-1], emax=8)
    with pytest.raises(ValueError):
        f2_rank_check(arrays, e, emax=-1)
