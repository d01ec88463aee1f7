"""A control and faults that stand in for a mix's entry, to show that the
check fails them.

* ``half_width`` is the control. The configurations state no precision; it
  breaks their guarantee that every delivered symbol is bit-exact, as a
  decoder of lower precision would: the entry works on the low half of each
  symbol's words, and the high half is delivered as it arrived.
* ``unchanged``: the entry hands its input back (received frames, their
  masks, no frame flagged; for a send mix the source and zero parity).
* ``half_batch``: the entry works on the first half of the batch; the rest
  is handed back unsolved and claimed solved.
* ``altered``: one bit of one delivered symbol of frame 0 is flipped where
  the entry produced it, a symbol that was lost where there is one.
* ``writes_input``: the entry's output is right, but it changes a word of its
  input, as a kernel that works in place would.
* ``flaky``: on every third call only, one bit of one delivered symbol (a
  lost one where there is one) is flipped in every 64th frame, from an offset
  that moves with the call, as a race or a stale buffer would show: a frame's
  last call may be a sound one.

A simulation mix (``POOL = "sim"``) returns counters, not frames; each kind
has a meaning there, and every one applies:

* ``half_width``, the control: the program's step with a decoder stopped
  short, ``max_iters`` 5 (its histogram read in the cell's bins), which
  breaks the guarantee that the peel recovers every frame outside the
  erasures' stopping set;
* ``unchanged``: the counters as they start, as if no batch ran;
* ``half_batch``: half of the call's batches run, their counters doubled;
* ``altered``: one more block error at every visit of call 0;
* ``writes_input``: the counters of the next call index, as a stale buffer
  would hand back;
* ``flaky``: one more block error on every third call.
"""

from __future__ import annotations

import torch

from codec_bench.port import Out

KINDS = ("half_width", "unchanged", "half_batch", "altered", "writes_input", "flaky")


def _handed_back(mix, state, inputs) -> Out:
    if mix.POOL == "tx":
        (source,) = inputs
        parity = source.new_zeros(source.shape[0], state.arrays.m, source.shape[2])
        return Out(torch.cat([source, parity], dim=1), None, None)
    received, mask = inputs
    return Out(received.clone(), mask.clone(), mask.new_zeros(mask.shape[0]))


def _cat(a: Out, b: Out, dim: int) -> Out:
    def cat(x, y):
        return None if x is None else torch.cat([x, y], dim=dim)

    return Out(cat(a.values, b.values), cat(a.erased, b.erased), cat(a.failed, b.failed))


def _sim(kind: str, mix, state):
    """The simulation step of ``mix`` broken as ``kind`` says."""
    bins = state.cfg.decoder.max_iters + 1
    other = {"half_width": lambda: mix.variant(state, max_iters=5),
             "half_batch": lambda: mix.variant(state, steps_per_call=state.cfg.steps_per_call // 2)}
    broken = other[kind]() if kind in other else state
    calls = [0]

    def call(j):
        calls[0] += 1
        if kind == "writes_input":
            j = (j + 1) % state.pool_calls
        s = mix.call(broken, j)
        if kind == "half_width":
            return s._replace(iters_hist=torch.nn.functional.pad(
                s.iters_hist, (0, bins - s.iters_hist.shape[0])))
        if kind == "half_batch":
            return s._make(2 * t for t in s)
        if kind == "unchanged":
            return s._make(torch.zeros_like(t) for t in s)
        if (kind == "altered" and j == 0) or (kind == "flaky" and calls[0] % 3 == 0):
            return s._replace(block_errors=s.block_errors + 1)
        return s

    return call


def wrap(kind: str, mix, state):
    """The entry of ``mix`` broken as ``kind`` says."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    if mix.POOL == "sim":
        return _sim(kind, mix, state)
    calls = [0]

    def call(*inputs):
        calls[0] += 1
        if kind == "unchanged":
            return _handed_back(mix, state, inputs)
        if kind == "half_width":
            w = inputs[0].shape[2] // 2
            low = mix.call(state, inputs[0][:, :, :w].contiguous(), *inputs[1:])
            high = _handed_back(mix, state, (inputs[0][:, :, w:].contiguous(), *inputs[1:]))
            return low._replace(values=torch.cat([low.values, high.values], dim=2))
        if kind == "half_batch":
            h = inputs[0].shape[0] // 2
            solved = mix.call(state, *(x[:h] for x in inputs))
            rest = _handed_back(mix, state, tuple(x[h:] for x in inputs))
            if rest.erased is not None:
                rest = rest._replace(erased=torch.zeros_like(rest.erased))
            return _cat(solved, rest, 0)
        out = mix.call(state, *inputs)
        if kind == "writes_input":
            inputs[0][0, 0, 0] += 1
            return out
        if kind == "flaky":
            if calls[0] % 3 == 0:
                rows = torch.arange((calls[0] // 3) % 64, out.values.shape[0], 64,
                                    device=out.values.device)
                p = torch.zeros_like(rows)
                if mix.POOL == "rx":
                    k = state.arrays.n - state.arrays.m
                    p = (inputs[1][rows] & ~out.erased[rows])[:, :k].to(torch.uint8).argmax(dim=1)
                out.values[rows, p, 0] ^= 1
            return out
        p = out.values.shape[1] - 1  # a parity symbol of a sent frame
        if mix.POOL == "rx":
            k = state.arrays.n - state.arrays.m
            lost = (inputs[1][0] & ~out.erased[0])[:k]
            p = int(lost.nonzero()[0, 0]) if bool(lost.any()) else 0
        out.values[0, p, 0] ^= 1
        return out

    return call
