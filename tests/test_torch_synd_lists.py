"""The topology syndrome on the list route, on the CPU.

``syndrome_from_topo`` launches ``f2_matvec_wide``'s list route on CUDA
tensors with the code's Vlist as its row lists (``vlist_idx`` padded with
n, ``vlist_len``) over K = n symbols, and keeps ``csrc/synd.cu``'s walk for
the shapes where no slab fits. Here the list route's plain version on the
Vlist is held against the JAX package's ``pallas_synd.syndrome_from_topo``
in interpret mode (as tests/test_pallas_synd.py runs it), and the route
choice is checked from the shapes alone. The kernels run on the card
(tests/test_torch_cuda.py, chip_smoke.py). GF(2) sums are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.codes import get_code as jax_get_code
from ldpc_erasure_codes_tpu.codes import toy_code as jax_toy_code
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.ops.pallas_peel import static_topology
from ldpc_erasure_codes_tpu.ops.pallas_synd import syndrome_from_topo as jax_syndrome
from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops import nbmm, synd
from ldpc_erasure_codes_tpu_torch.ops._build import SMEM_LIMIT
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from torch_port_cases import random_words, to_port_code, to_torch, to_words


@pytest.mark.parametrize("which", ["toy", "n2040_k1530"])
def test_vlist_lists_match_pallas(which):
    """The Vlist as row lists through ``f2_matvec_rows_reference`` equals
    JAX's constant-topology syndrome (B = 4 frames of W = 4 words, a fifth
    of the slots erased to zero), and the wrapper's CPU path."""
    jcode = jax_toy_code() if which == "toy" else jax_get_code(which)
    n, m = jcode.n, jcode.m
    rng = np.random.default_rng(n)
    b, w = 4, 4
    values = random_words(rng, (b, n, w))
    values[rng.random((b, n)) < 0.2] = 0  # erased slots hold zero
    want = np.asarray(jax_syndrome(
        jnp.asarray(values), topo=static_topology(device_arrays(jcode)),
        m_pad=-(-m // 8) * 8, bt=4, interpret=True,
    ))
    want = np.ascontiguousarray(want).view(np.uint32)[:, :m]
    arrays = code_arrays(to_port_code(jcode), "cpu")
    got = nbmm.f2_matvec_rows_reference(to_torch(values), arrays.vlist_idx, arrays.vlist_len)
    np.testing.assert_array_equal(to_words(got), want)
    before = synd.syndrome_from_topo.launches
    assert torch.equal(synd.syndrome_from_topo(arrays, to_torch(values)), got)
    assert synd.syndrome_from_topo.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("name,wc", [("n2040_k1530", 16), ("n2000_k1000", 16),
                                     ("n4000_k2000", 8)])
def test_routes_from_shapes(name, wc):
    """The shipped codes at W = 256 take the list route at the slab width
    ``f2_slab_words`` gives their Vlist ((4000,2000)'s 16-word slab is over
    shared memory); W = 3 takes Wc 4."""
    code = get_code(name)
    arrays = code_arrays(code, "cpu")
    assert synd.synd_route(code.n, code.m, arrays.dmax, 256) == "list"
    assert nbmm.f2_slab_words(arrays.vlist_idx, code.n, 256) == wc
    assert nbmm.f2_rows_slab_words(code.n, code.m, arrays.dmax, 256) == wc
    assert nbmm.f2_slab_words(arrays.vlist_idx, code.n, 3) == 4
    assert nbmm.f2_rows_smem(code.n, code.m, arrays.dmax, wc) <= SMEM_LIMIT


def test_walk_where_no_slab_fits():
    """The walk route takes n >= 65535 (uint16 lists), lists wider than
    n // 8, and a slab over shared memory even at 4 words."""
    assert synd.synd_route(70000, 35000, 7, 256) == "walk"
    assert synd.synd_route(48, 16, 7, 256) == "walk"
    assert synd.synd_route(48, 16, 6, 256) == "list"
    assert nbmm.f2_rows_smem(60000, 30000, 7, 4) > SMEM_LIMIT
    assert synd.synd_route(60000, 30000, 7, 256) == "walk"
