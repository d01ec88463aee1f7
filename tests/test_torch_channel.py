"""The port's fused per64 channel (``ops/channel.py``) on the CPU.

The TPU kernel draws its words from the hardware PRNG, which the Pallas
interpreter stubs to zeros, so the JAX side is compared on the masking rule
alone, on all-zero words. The port's words are Philox-4x32-10, checked
against Random123's known-answer vectors; the distribution is checked on
the plain version's draws (4 sigma), as the kernel computes the same words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_erasure_codes_tpu.ops.pallas_channel import channel_apply_per64 as jax_channel
from ldpc_erasure_codes_tpu_torch.ops.channel import (
    channel_apply_per64,
    channel_apply_per64_reference,
    channel_bits,
    erase_per64,
    philox4x32,
)
from torch_port_cases import random_words, to_torch, to_words

# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    assert tuple(int(x) for x in philox4x32(counter, key)) == want


def _values(b=6, n=200, w=3, seed=0):
    return to_torch(random_words(np.random.default_rng(seed), (b, n, w)))


@pytest.mark.parametrize("num", [0, 1, 9, 40, 64])
def test_masking_is_exact(num):
    values = _values()
    recv, mask = channel_apply_per64(values, 1234, num)
    assert mask.dtype == torch.bool and mask.shape == values.shape[:2]
    assert recv.dtype == values.dtype and recv.shape == values.shape
    assert torch.equal(recv[~mask], values[~mask])
    assert not recv[mask].any()
    assert (not mask.any()) if num == 0 else True
    assert mask.all() if num == 64 else True


def test_mask_is_a_function_of_seed_frame_symbol():
    values = _values(b=8, n=300, w=2)
    _, mask = channel_apply_per64(values, 7, 20)
    _, sub = channel_apply_per64(values[:3].contiguous(), 7, 20)
    assert torch.equal(sub, mask[:3])
    _, narrow = channel_apply_per64(values[:, :, :1].contiguous(), 7, 20)
    assert torch.equal(narrow, mask)  # the words carried do not matter
    recv_b, bytes_mask = channel_apply_per64(values.view(torch.uint8), 7, 20)
    assert recv_b.dtype == torch.uint8 and torch.equal(bytes_mask, mask)
    assert torch.equal(recv_b.view(torch.int32), channel_apply_per64(values, 7, 20)[0])
    _, other = channel_apply_per64(values, 8, 20)
    assert not torch.equal(other, mask)
    # Seeds are taken modulo 2^32.
    assert torch.equal(channel_apply_per64(values, 7 + 2**32, 20)[1], mask)


@pytest.mark.parametrize("num", [9, 12])
def test_erasure_rate_within_four_sigma(num):
    b, n = 64, 2040
    bits = channel_bits((b, n), 2024, "cpu")
    mask = (bits & 63) < num
    p = num / 64
    sigma = (p * (1 - p) / (b * n)) ** 0.5
    assert abs(float(mask.float().mean()) - p) < 4 * sigma
    # The low six bits are uniform over 0..63 (a chi-square of 63 degrees of
    # freedom, 4 sigma above its mean).
    counts = torch.bincount((bits & 63).reshape(-1), minlength=64).double()
    expect = b * n / 64
    assert float(((counts - expect) ** 2 / expect).sum()) < 63 + 4 * (2 * 63) ** 0.5


@pytest.mark.parametrize("num", [0, 1, 16])
def test_masking_rule_matches_jax_on_zero_words(num):
    """Under the Pallas interpreter the TPU kernel's words are zero: every
    symbol is erased for num >= 1 and none for num = 0; the port's rule on
    zero words gives the same (recv, mask)."""
    from jax.experimental.pallas import tpu as pltpu

    vals = random_words(np.random.default_rng(3), (8, 256, 4))
    with pltpu.force_tpu_interpret_mode():
        recv_j, mask_j = jax_channel(jnp.asarray(vals), jnp.int32(5), jnp.int32(num))
    recv_j, mask_j = jax.device_get((recv_j, mask_j))
    recv, mask = erase_per64(to_torch(vals), torch.zeros((8, 256), dtype=torch.int64), num)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(to_words(recv), np.asarray(recv_j))


def test_channel_refuses_bad_input():
    values = _values()
    before = channel_apply_per64.launches
    with pytest.raises(ValueError):
        channel_apply_per64(values, 0, 65)
    with pytest.raises(ValueError):
        channel_apply_per64(values, 0, -1)
    with pytest.raises(ValueError):
        channel_apply_per64(values.view(torch.uint8)[:, :, :6].contiguous(), 0, 3)
    with pytest.raises(TypeError):
        channel_apply_per64(values.float(), 0, 3)
    assert channel_apply_per64.launches == before  # CPU tensors: the plain version
    assert torch.equal(channel_apply_per64(values, 3, 9)[1],
                       channel_apply_per64_reference(values, 3, 9)[1])
