"""Peeling decode of packed words, in the schedules of the TPU kernel.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_peel.py::
peel_decode_vmem`` (:1281-1786) and its ``schedule`` argument
(:1456-1464). The TPU's tile-major layout exists only for its VMEM; the
port keeps the plain (B, n, W) layout end to end. For CUDA tensors
:func:`peel_decode` launches ``csrc/peel.cu`` for every schedule, two
kernels: a per-frame schedule of the sweep's resolutions, sorted into
independent levels, then the values of each (frame, chunk of Wc words) out
of a shared-memory slab (:func:`launch_kernel`). The schedule kernel visits
the checks in one of four orders: check by check ("seq", "unrolled" +
fence gate, the production schedules; plain version
:func:`peel_schedule_reference`), by the disjoint check groups of
``CodeArrays.check_groups`` ("grouped", the same list bit for bit;
:func:`grouped_schedule_reference`), by windows of live per-check counts
("counted", the same list bit for bit; :func:`counted_schedule_reference`),
or with sweep-start detection ("jacobi", the XLA decoders' schedule,
:mod:`.peel_jacobi`; :func:`jacobi_schedule_reference`). The value kernel's
plain version is :func:`apply_schedule_reference`.

For CPU tensors it runs the plain versions: :func:`peel_decode_reference`
for the four sequential schedules, which compute one function bit for bit,
iteration counts included, and
:func:`.peel_jacobi.peel_decode_jacobi_reference` for "jacobi".

GF(256) codes (``gf_order=256``) take uint8 byte symbols (W % 4 == 0),
viewed as int32 words of four bytes. A degree-1 check's weighted sum
``acc = sum_j coef_j * y_j`` leaves out the erased slot, which holds zero,
and the solved symbol is ``inv_s * acc`` (pallas_peel.py:295-300,
My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:37-48). The erasure mask and
the iteration counts evolve as in the binary decode: they do not depend on
the values or the coefficients.

Stopping is per frame: a frame stops after the first sweep that leaves its
first ``early_stop_k`` symbols known, or that changes nothing. The TPU
kernel stops per 32-frame tile, so with ``early_stop_k`` the two agree on
iteration counts, on the first-k mask and on every resolved value, and the
parity-region residual may differ (pallas_peel.py:1314-1320). The kernel
and :func:`peel_decode_reference` agree bit for bit on every output.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.gf.ops import as_words, gf_mul_packed
from ldpc_erasure_codes_tpu_torch.ops import _build
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu_torch.ops.peel_jacobi import peel_decode_jacobi_reference
from ldpc_erasure_codes_tpu_torch.utils import profiling

SCHEDULES = ("seq", "unrolled", "counted", "grouped", "jacobi")
# The schedule kernel's visit order (csrc/peel.cu) per schedule.
_ORDER = {"seq": 0, "unrolled": 0, "grouped": 1, "jacobi": 2, "counted": 3}


def _words(values: torch.Tensor, gf_order: int) -> torch.Tensor:
    """The int32 words the decode works on: ``values`` itself (binary) or
    the word view of its bytes (GF(256))."""
    if gf_order == 256:
        return as_words(values, "values")
    if gf_order != 2:
        raise ValueError(f"gf_order must be 2 or 256, got {gf_order}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be torch.int32 words, got {values.dtype}")
    return values


def _check(arrays: CodeArrays, values, erased, max_iters, early_stop_k) -> int:
    """Validate the inputs (``values`` as int32 words); returns k_stop."""
    if erased.dtype != torch.bool:
        raise TypeError(f"erased must be torch.bool, got {erased.dtype}")
    if values.dim() != 3 or values.shape[2] < 1:
        raise ValueError(f"values must be (B, n, W) with W >= 1, got {tuple(values.shape)}")
    b, n, _ = values.shape
    if erased.shape != (b, n):
        raise ValueError(f"erased shape {tuple(erased.shape)} != {(b, n)}")
    if n < arrays.min_n:
        raise ValueError(f"n={n} is shorter than the code's columns ({arrays.min_n})")
    if not (values.device == erased.device == arrays.device):
        raise ValueError(
            f"values on {values.device}, erased on {erased.device}, "
            f"code tables on {arrays.device}"
        )
    if not (values.is_contiguous() and erased.is_contiguous()):
        raise ValueError("values and erased must be contiguous")
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} must be >= 0")
    k_stop = n if early_stop_k is None else int(early_stop_k)
    if not 0 <= k_stop <= n:
        raise ValueError(f"early_stop_k={early_stop_k} outside 0..{n}")
    return k_stop


def peel_decode_reference(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode: a Python loop over sweeps and checks,
    vectorised over frames and words, with the kernel's per-frame stop."""
    words = _words(values, gf_order)
    k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
    nbin = gf_order == 256
    b = words.shape[0]
    dev = words.device
    er = erased.clone()
    v = words.masked_fill(er[:, :, None], 0)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    lens = arrays.vlist_len.tolist()
    checks = [
        torch.tensor(row[:d], dtype=torch.long, device=dev)
        for row, d in zip(arrays.vlist_idx.tolist(), lens)
    ]
    coefs = [row[:d] for row, d in zip(arrays.vlist_val.tolist(), lens)]
    invs = [
        torch.tensor(row[:d], dtype=torch.int32, device=dev)
        for row, d in zip(arrays.vlist_inv_val.tolist(), lens)
    ]
    for it in range(max_iters):
        changed = torch.zeros(b, dtype=torch.bool, device=dev)
        for c, nb in enumerate(checks):
            e_nb = er[:, nb]  # (B, d)
            deg1 = (e_nb.sum(dim=1) == 1) & active
            if not bool(deg1.any()):
                continue
            f = deg1.nonzero().squeeze(1)
            rows = v[f[:, None], nb[None, :]]  # (F, d, W); the erased slot holds zero
            pos = e_nb[f].to(torch.int8).argmax(dim=1)  # (F,) the erased slot
            if nbin:
                acc = gf_mul_packed(rows[:, 0], coefs[c][0])
                for j in range(1, nb.numel()):
                    acc = acc ^ gf_mul_packed(rows[:, j], coefs[c][j])
                acc = gf_mul_packed(acc, invs[c][pos][:, None])
            else:
                acc = rows[:, 0]
                for j in range(1, nb.numel()):
                    acc = acc ^ rows[:, j]
            slot = nb[pos]
            v[f, slot] = acc
            er[f, slot] = False
            changed[f] = True
        fin = active & (er[:, :k_stop].sum(dim=1) == 0)
        iters[fin] = it + 1
        active = active & ~fin & changed
        if not bool(active.any()):
            break
    return (v.view(torch.uint8) if nbin else v), er, iters


def _check_erased(erased: torch.Tensor, early_stop_k: int | None) -> int:
    if erased.dtype != torch.bool or erased.dim() != 2:
        raise ValueError(f"erased must be (B, n) bool, got {tuple(erased.shape)} {erased.dtype}")
    return erased.shape[1] if early_stop_k is None else int(early_stop_k)


def _sorted_schedule(seq, seq_lev, erased, iters) -> tuple[torch.Tensor, ...]:
    """The schedule kernels' format from each frame's resolutions in sweep
    order (``seq``, -1 past the end) and their levels (``seq_lev``, n + 1
    past the end): the list sorted by level, stable; the level offsets; the
    level counts; then ``erased`` and ``iters``."""
    b, n = seq.shape
    order = torch.sort(seq_lev, dim=1, stable=True).indices
    res = seq.gather(1, order)
    valid = seq_lev <= n
    hist = torch.zeros((b, n + 1), dtype=torch.int32, device=seq.device)
    hist.scatter_add_(1, seq_lev.clamp(max=n).long(), valid.to(torch.int32))
    lvl_off = hist.cumsum(dim=1, dtype=torch.int32)
    nlev = torch.where(valid, seq_lev, 0).max(dim=1).values.to(torch.int32)
    return res, lvl_off, nlev, erased, iters


def _visit_schedule(arrays: CodeArrays, erased: torch.Tensor, visits: list[list[int]],
                    max_iters: int, early_stop_k: int | None) -> tuple[torch.Tensor, ...]:
    """The sequential mask sweep, visiting the checks of each entry of
    ``visits`` together: every member is tested on the state at the entry's
    start, then the members' resolutions are recorded in member order."""
    k_stop = _check_erased(erased, early_stop_k)
    b, n = erased.shape
    dev = erased.device
    lev = torch.where(erased, -1, 0).to(torch.int32)  # -1: erased
    seq = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    seq_lev = torch.full((b, n), n + 1, dtype=torch.int32, device=dev)  # pad sorts last
    nres = torch.zeros(b, dtype=torch.long, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    lens = arrays.vlist_len.tolist()
    checks = [torch.tensor(row[:d], dtype=torch.long, device=dev)
              for row, d in zip(arrays.vlist_idx.tolist(), lens)]
    for it in range(max_iters):
        changed = torch.zeros(b, dtype=torch.bool, device=dev)
        for members in visits:
            found = []
            for c in members:
                l_nb = lev[:, checks[c]]  # (B, d)
                deg1 = ((l_nb < 0).sum(dim=1) == 1) & active
                if bool(deg1.any()):
                    f = deg1.nonzero().squeeze(1)
                    pos = (l_nb[f] < 0).to(torch.int8).argmax(dim=1)
                    found.append((c, f, pos, l_nb[f].clamp(min=0).max(dim=1).values + 1))
            for c, f, pos, level in found:
                lev[f, checks[c][pos]] = level
                seq[f, nres[f]] = (c << 8) | pos.to(torch.int32)
                seq_lev[f, nres[f]] = level
                nres[f] += 1
                changed[f] = True
        fin = active & ((lev[:, :k_stop] < 0).sum(dim=1) == 0)
        iters[fin] = it + 1
        active = active & ~fin & changed
        if not bool(active.any()):
            break
    return _sorted_schedule(seq, seq_lev, lev < 0, iters)


def peel_schedule_reference(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the schedule kernel of ``csrc/peel.cu`` in its
    check-by-check order: the sequential mask sweep of
    :func:`peel_decode_reference`, which records each resolution and its
    level.

    Returns (res (B, n) int32, lvl_off (B, n + 1) int32, nlev (B,) int32,
    erased (B, n) bool, iters (B,) int32). A resolution is ``c << 8 | es``:
    check ``c`` solved its erased neighbour at list slot ``es``. Its level
    is 1 + the largest level among the check's other neighbours (known
    inputs are level 0), so resolutions of one level are independent.
    ``res[b]`` lists frame b's resolutions sorted by level, in sweep order
    within a level, then -1; ``lvl_off[b, l]`` counts those of level <= l;
    ``nlev[b]`` is the largest level (0 when nothing resolved).
    """
    return _visit_schedule(arrays, erased, [[c] for c in range(arrays.m)], max_iters,
                           early_stop_k)


def grouped_schedule_reference(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the schedule kernel in its grouped order: the
    groups of ``arrays.check_groups`` in turn, each group's members tested
    together on the group-start state, then recorded in member order. The
    members share no symbol, so this equals :func:`peel_schedule_reference`
    on every output; same format."""
    m = arrays.m
    visits = [[c for c in row if c < m] for row in arrays.check_groups.tolist()]
    return _visit_schedule(arrays, erased, visits, max_iters, early_stop_k)


def counted_schedule_reference(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the schedule kernel in its counted order: each
    check's erased neighbours are counted once from the Vlist and lowered
    through the Clist as symbols resolve; a sweep reads the counts in
    windows of 32 checks, and within a window resolves the first count-1
    check at or past the window's cursor, then moves the cursor past it and
    reads the window again. Counts only fall, so the checks passed over are
    those the sequential sweep skips: this equals
    :func:`peel_schedule_reference` on every output; same format."""
    k_stop = _check_erased(erased, early_stop_k)
    b, n = erased.shape
    m, dev = arrays.m, erased.device
    nc, cmax = arrays.clist_idx.shape
    # Neighbour lists padded to symbol n (a known slot of level 0) and check
    # lists padded to check m (a count nobody reads); symbols past the
    # code's columns have no checks.
    vidx = torch.where(torch.arange(arrays.dmax, device=dev) < arrays.vlist_len[:, None],
                       arrays.vlist_idx, n).long()
    cidx = torch.where(torch.arange(cmax, device=dev) < arrays.clist_len[:, None],
                       arrays.clist_idx, m).long()
    cidx = torch.cat([cidx, cidx.new_full((n + 1 - nc, cmax), m)])
    lev = torch.cat([torch.where(erased, -1, 0), erased.new_zeros((b, 1), dtype=torch.int64)],
                    dim=1).to(torch.int32)  # -1: erased
    cnt = torch.cat([(lev[:, vidx] < 0).sum(dim=2), lev.new_zeros((b, 1), dtype=torch.int64)],
                    dim=1)
    seq = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    seq_lev = torch.full((b, n), n + 1, dtype=torch.int32, device=dev)  # pad sorts last
    nres = torch.zeros(b, dtype=torch.long, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        changed = torch.zeros(b, dtype=torch.bool, device=dev)
        for c0 in range(0, m, 32):
            window = torch.arange(c0, min(c0 + 32, m), device=dev)
            cursor = torch.full((b,), c0, dtype=torch.long, device=dev)
            while True:
                hit = ((cnt[:, window] == 1) & (window[None, :] >= cursor[:, None])
                       & active[:, None])
                f = hit.any(dim=1).nonzero().squeeze(1)
                if f.numel() == 0:
                    break
                c = window[hit[f].to(torch.int8).argmax(dim=1)]  # the first hit
                nb = vidx[c]  # (F, dmax)
                l_nb = lev[f[:, None], nb]
                pos = (l_nb < 0).to(torch.int8).argmax(dim=1)
                level = l_nb.max(dim=1).values.clamp(min=0) + 1
                e = nb[torch.arange(f.numel(), device=dev), pos]
                lev[f, e] = level
                seq[f, nres[f]] = ((c << 8) | pos).to(torch.int32)
                seq_lev[f, nres[f]] = level
                nres[f] += 1
                changed[f] = True
                ch = cidx[e]  # (F, cmax): distinct checks, then the pad
                cnt.index_put_((f[:, None].expand_as(ch), ch),
                               torch.full(ch.shape, -1, dtype=cnt.dtype, device=dev),
                               accumulate=True)
                cursor[f] = c + 1
        fin = active & ((lev[:, :k_stop] < 0).sum(dim=1) == 0)
        iters[fin] = it + 1
        active = active & ~fin & changed
        if not bool(active.any()):
            break
    return _sorted_schedule(seq, seq_lev, lev[:, :n] < 0, iters)


def jacobi_schedule_reference(
    arrays: CodeArrays,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the schedule kernel in its Jacobi order, the mask
    sweep of :func:`.peel_jacobi.peel_decode_jacobi_reference` with its
    per-frame stop: every check is tested on the sweep-start flags; each
    erased symbol with a degree-1 check is resolved by the highest-numbered
    one (its owner), at level = the sweep's number. Format of
    :func:`peel_schedule_reference`; within a level the owners are in check
    order. :func:`apply_schedule_reference` on it gives the Jacobi decode's
    values."""
    k_stop = _check_erased(erased, early_stop_k)
    b, n = erased.shape
    m, dev = arrays.m, erased.device
    idx = arrays.vlist_idx.long()  # (m, dmax), pad = n
    checks = torch.arange(m, device=dev)
    er = erased.clone()
    seq = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    seq_lev = torch.full((b, n), n + 1, dtype=torch.int32, device=dev)
    nres = torch.zeros(b, dtype=torch.long, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        ev = torch.cat([er, er.new_zeros(b, 1)], dim=1)[:, idx]  # (B, m, dmax)
        deg1 = (ev.sum(dim=2) == 1) & active[:, None]
        es = ev.to(torch.int8).argmax(dim=2)  # (B, m) the erased slot
        target = torch.where(deg1, idx[checks, es], n)
        owner = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
        owner = owner.scatter_reduce(1, target, checks.expand(b, m), reduce="amax")
        own = deg1 & (owner.gather(1, target) == checks)
        fi, ci = own.nonzero(as_tuple=True)  # by frame, then check
        pos = nres[fi] + (own.cumsum(dim=1) - 1)[fi, ci]
        seq[fi, pos] = ((ci << 8) | es[fi, ci]).to(torch.int32)
        seq_lev[fi, pos] = it + 1
        er[fi, target[fi, ci]] = False
        nres += own.sum(dim=1)
        fin = active & ~er[:, :k_stop].any(dim=1)
        iters[fin] = it + 1
        active = active & ~fin & own.any(dim=1)
        if not bool(active.any()):
            break
    return _sorted_schedule(seq, seq_lev, er, iters)


def apply_schedule_reference(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    res: torch.Tensor,
    lvl_off: torch.Tensor,
    *,
    gf_order: int = 2,
) -> torch.Tensor:
    """Plain version of the value kernel of ``csrc/peel.cu``: the frames
    with their erased slots zeroed, then each resolution of ``res`` applied
    in list order (a check's erased slot set to the sum of its neighbours;
    GF(256): ``inv_s * sum_j coef_j * y_j``). Values in the input's type."""
    words = _words(values, gf_order)
    b, n, w = words.shape
    dev = words.device
    v = words.masked_fill(erased[:, :, None], 0)
    nres = lvl_off[:, -1]
    dmax = arrays.dmax
    slots = torch.arange(dmax, device=dev)
    for r in range(int(nres.max()) if b else 0):
        f = (nres > r).nonzero().squeeze(1)
        t = res[f, r].long()
        c, es = t >> 8, t & 255
        nb = arrays.vlist_idx[c].long()  # (F, dmax), pad n
        live = slots[None, :] < arrays.vlist_len[c][:, None]
        rows = v[f[:, None], nb.clamp(max=n - 1)]  # (F, dmax, W)
        if gf_order == 256:
            rows = gf_mul_packed(rows, arrays.vlist_val[c][:, :, None])
        rows = rows.masked_fill(~live[:, :, None], 0)
        acc = rows[:, 0]
        for j in range(1, dmax):
            acc = acc ^ rows[:, j]
        if gf_order == 256:
            acc = gf_mul_packed(acc, arrays.vlist_inv_val[c, es][:, None])
        v[f, nb[torch.arange(len(f), device=dev), es]] = acc
    return v.view(torch.uint8) if gf_order == 256 else v


SMEM_LIMIT = _build.SMEM_LIMIT
SLAB_WORDS = (16, 12, 8, 4)
_r16 = _build.round16


def schedule_smem(arrays: CodeArrays, n: int) -> int:
    """Shared memory of a one-warp block of the schedule kernel: the Vlist
    and the Clist as uint16 and, for each of the warp's 32 / G frames
    (G = 8, 16 or 32 lanes, the first that holds dmax), its levels, sort
    counters and per-check erased counts (csrc/peel.cu)."""
    m, dmax = arrays.m, arrays.dmax
    nc, cmax = arrays.clist_idx.shape
    frames = 32 // (8 if dmax <= 8 else 16 if dmax <= 16 else 32)
    return (_r16(2 * m * dmax) + _r16(2 * m) + _r16(2 * nc * cmax) + _r16(2 * nc)
            + frames * (_r16(2 * n) + _r16(2 * (n + 2)) + _r16(2 * m)))


def apply_smem(n: int, m: int, dmax: int, wc: int, gf_order: int) -> int:
    """Shared memory of a value-kernel block (csrc/peel.cu): the slab of n
    symbols x Wc words, the Vlist as uint16 (GF(256): and its coefficients
    and inverses), the frame's resolutions and level offsets."""
    nb = 2 * _r16(m * dmax) if gf_order == 256 else 0
    return (4 * n * wc + _r16(2 * m * dmax) + _r16(2 * m) + nb + _r16(4 * n)
            + _r16(4 * (n + 1)))


def slab_words(arrays: CodeArrays, n: int, w: int, gf_order: int = 2) -> int:
    """Words per block of the seq/unrolled value kernel (Wc): the widest of
    :data:`SLAB_WORDS` whose block fits in shared memory, no wider than W
    rounded up to 4 (wider chunks read longer runs of each symbol; at the
    main path Wc = 16, one block per SM, beat Wc = 8, two, PERF.md). Raises
    where even Wc = 4 exceeds a block's shared memory."""
    m, dmax = arrays.m, arrays.dmax
    need = max(apply_smem(n, m, dmax, 4, gf_order), schedule_smem(arrays, n))
    if need > SMEM_LIMIT:
        raise ValueError(
            f"n={n}, m={m}, dmax={dmax}: the peel kernel's slab of n x 4 words with the staged "
            f"tables (or its schedule's) takes {need} bytes, over the {SMEM_LIMIT}-byte "
            "shared-memory limit of a block")
    fits = [wc for wc in SLAB_WORDS if wc <= max(4, -(-w // 4) * 4)
            and apply_smem(n, m, dmax, wc, gf_order) <= SMEM_LIMIT]
    return fits[0] if fits else 4


def _schedule_buffers(b: int, n: int, dev) -> tuple[torch.Tensor, ...]:
    """The schedule's int32 buffers: seq (B, n), the kernel's scratch, then
    res (B, n), lvl_off (B, n + 1), nlev (B,)."""
    return (torch.empty((b, n), dtype=torch.int32, device=dev),
            torch.empty((b, n), dtype=torch.int32, device=dev),
            torch.empty((b, n + 1), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev))


def _counter(schedule: str, gf_order: int) -> str:
    """The launch counter of ``peel_decode`` that a schedule's kernel adds to."""
    base = "launches" if schedule in ("seq", "unrolled") else f"launches_{schedule}"
    return base + ("_gf256" if gf_order == 256 else "")


def launch_schedule(arrays: CodeArrays, erased: torch.Tensor, k_stop: int, max_iters: int,
                    schedule: str = "seq"):
    """The schedule kernel of ``csrc/peel.cu`` on CUDA tensors, in the
    visit order of ``schedule`` ("seq"/"unrolled", "grouped", "counted" or
    "jacobi"): (res (B, n), lvl_off (B, n + 1), nlev (B,), erased (B, n)
    bool, iters (B,)), in the format of :func:`peel_schedule_reference`."""
    b, n = erased.shape
    if arrays.dmax > 256 or schedule_smem(arrays, n) > SMEM_LIMIT:
        raise ValueError(f"the schedule kernel takes dmax <= 256 and the Vlist and Clist in "
                         f"shared memory: dmax={arrays.dmax}, {schedule_smem(arrays, n)} bytes "
                         f"for n={n}, m={arrays.m}")
    dev = erased.device
    seq, res, lvl_off, nlev = _schedule_buffers(b, n, dev)
    er_out = torch.empty((b, n), dtype=torch.bool, device=dev)
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    rc = _build.library().ldpc_peel_schedule_launch(
        _ORDER[schedule], erased.data_ptr(), arrays.vlist_idx.data_ptr(),
        arrays.vlist_len.data_ptr(), arrays.clist_idx.data_ptr(), arrays.clist_len.data_ptr(),
        arrays.check_groups.data_ptr(), arrays.check_groups.shape[0], seq.data_ptr(),
        res.data_ptr(), lvl_off.data_ptr(), nlev.data_ptr(), er_out.data_ptr(),
        iters.data_ptr(), b, n, arrays.m, arrays.dmax, *arrays.clist_idx.shape, k_stop,
        max_iters,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "ldpc_peel_schedule_launch")
    return res, lvl_off, nlev, er_out, iters


def launch_kernel(arrays: CodeArrays, words: torch.Tensor, erased: torch.Tensor, k_stop: int,
                  max_iters: int, gf_order: int, wc: int | None = None, schedule: str = "seq"):
    """The peel of ``csrc/peel.cu`` on CUDA tensors (``words`` int32): the
    schedule kernel in the visit order of ``schedule`` ("seq"/"unrolled",
    "grouped", "counted" or "jacobi"), then the value kernel with ``wc``
    words per block (:func:`slab_words` by default). Counts one launch of
    ``peel_decode`` under the schedule's counter (``launches`` for
    seq/unrolled, ``launches_<schedule>`` otherwise; ``_gf256`` for
    GF(256)). Returns int32 words."""
    b, n, w = words.shape
    with profiling.span("peel.prep"):
        if arrays.dmax > 256:
            raise ValueError(
                f"the peel kernel keeps a check's slot in 8 bits: dmax={arrays.dmax}")
        wc = slab_words(arrays, n, w, gf_order) if wc is None else wc
        if (wc not in SLAB_WORDS
                or apply_smem(n, arrays.m, arrays.dmax, wc, gf_order) > SMEM_LIMIT):
            raise ValueError(f"slab of {wc} words: Wc must be one of {SLAB_WORDS} with the "
                             f"block's shared memory within {SMEM_LIMIT} bytes (n={n})")
        dev = words.device
        out = torch.empty_like(words)
        er_out = torch.empty((b, n), dtype=torch.bool, device=dev)
        iters = torch.empty((b,), dtype=torch.int32, device=dev)
        sched = _schedule_buffers(b, n, dev)
    with profiling.span("peel.launch"):
        rc = _build.library().ldpc_peel_launch(
            _ORDER[schedule], words.data_ptr(), erased.data_ptr(), arrays.vlist_idx.data_ptr(),
            arrays.vlist_len.data_ptr(), arrays.vlist_val.data_ptr(),
            arrays.vlist_inv_val.data_ptr(), arrays.clist_idx.data_ptr(),
            arrays.clist_len.data_ptr(), arrays.check_groups.data_ptr(),
            arrays.check_groups.shape[0], out.data_ptr(), er_out.data_ptr(), iters.data_ptr(),
            *(t.data_ptr() for t in sched), b, n, arrays.m, arrays.dmax,
            *arrays.clist_idx.shape, w, k_stop, max_iters, wc, int(gf_order == 256),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(rc, "ldpc_peel_launch")
    counter = _counter(schedule, gf_order)
    setattr(peel_decode, counter, getattr(peel_decode, counter) + 1)
    return out, er_out, iters


def peel_decode(
    arrays: CodeArrays,
    values: torch.Tensor,
    erased: torch.Tensor,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
    schedule: str = "seq",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peeling decode. Returns (values (B, n, W), erased (B, n) bool,
    iters (B,) int32), values in the input's type: int32 words for
    ``gf_order=2``, uint8 bytes (W % 4 == 0) for ``gf_order=256``.

    ``values`` may be the un-erased channel output: the masking is fused
    into the decode, and erased output slots hold zero. ``schedule`` is one
    of :data:`SCHEDULES` (the module docstring says which kernel runs
    each). CPU tensors take the plain versions; CUDA tensors launch the
    kernel (or raise). ``peel_decode.launches`` counts binary seq/unrolled
    launches of ``csrc/peel.cu``, ``peel_decode.launches_gf256`` its GF(256)
    ones, and ``launches_<schedule>`` / ``launches_<schedule>_gf256`` those
    of "counted", "grouped" and "jacobi".
    """
    with profiling.span("peel.decode", device=values.device):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        words = _words(values, gf_order)
        k_stop = _check(arrays, words, erased, max_iters, early_stop_k)
        kw = dict(max_iters=max_iters, early_stop_k=early_stop_k, gf_order=gf_order)
        if words.device.type == "cpu":
            with profiling.span("peel.launch"):  # the plain versions
                if schedule == "jacobi":
                    return peel_decode_jacobi_reference(arrays, values, erased, **kw)
                return peel_decode_reference(arrays, values, erased, **kw)
        if words.device.type != "cuda":
            raise ValueError(f"unsupported device {words.device}")
        out, er_out, iters = launch_kernel(arrays, words, erased, k_stop, max_iters, gf_order,
                                           schedule=schedule)
        return (out.view(torch.uint8) if gf_order == 256 else out), er_out, iters


peel_decode.launches = 0
peel_decode.launches_gf256 = 0
for _s in ("counted", "grouped", "jacobi"):
    setattr(peel_decode, f"launches_{_s}", 0)
    setattr(peel_decode, f"launches_{_s}_gf256", 0)
