"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one. The
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Kernels and plain versions are compared bit for bit (tolerance 0: the
operations are XORs and flag updates, with no rounding).
"""

import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import get_code
from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed, encode_packed_reference
from ldpc_erasure_codes_tpu_torch.ops.peel import peel_decode, peel_decode_reference
from torch_port_cases import cuda_device, random_words, to_torch  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data pointer is 4 bytes past a
    16-byte boundary (the kernels' one-word path)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (3, True)])
def test_encode_kernel_matches_plain(cuda_device, w, aligned):
    code = get_code("n2040_k1530")
    arrays = code_arrays(code, cuda_device)
    src = to_torch(random_words(np.random.default_rng(3), (8, code.k, w))).to(cuda_device)
    if not aligned:
        src = _misaligned(src)
    before = encode_packed.launches
    got = encode_packed(arrays, src)
    torch.cuda.synchronize()
    assert encode_packed.launches == before + 1
    torch.testing.assert_close(got, encode_packed_reference(arrays, src), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["n2040_k1530", "n4000_k2000"])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("w,aligned", [(256, True), (256, False), (5, True)])
def test_peel_kernel_matches_plain(cuda_device, name, early_stop, w, aligned):
    code = get_code(name)
    arrays = code_arrays(code, cuda_device)
    rng = np.random.default_rng(7)
    src = to_torch(random_words(rng, (16, code.k, w))).to(cuda_device)
    cw = encode_packed(arrays, src)
    if not aligned:
        cw = _misaligned(cw)
    mask = torch.from_numpy(rng.random((16, code.n)) < 0.1406).to(cuda_device)
    kw = dict(max_iters=50, early_stop_k=code.k if early_stop else None)
    before = peel_decode.launches
    got = peel_decode(arrays, cw, mask, **kw)
    torch.cuda.synchronize()
    assert peel_decode.launches == before + 1
    for g, r in zip(got, peel_decode_reference(arrays, cw, mask, **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_wrappers_refuse_mixed_devices(cuda_device):
    code = get_code("n2000_k1000")
    cpu_arrays = code_arrays(code, "cpu")
    src = torch.zeros((2, code.k, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        encode_packed(cpu_arrays, src)
    vals = torch.zeros((2, code.n, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        peel_decode(cpu_arrays, vals, torch.zeros((2, code.n), dtype=torch.bool))
