"""One run of one cell: set-up, the measured window, the check, the result.

A cell is ``workloads/<cell>.json``: its configuration (``configs/``), its
traffic (``traffic/``, read by :mod:`codec_bench.traffic`) and its ``why``.
The traffic names the mix (``mixes/``), whose entry each call drives.

Set-up builds a pool of batches on the card from the seed: for a receive mix,
source drawn and encoded by the program, then the lost symbols zeroed, with
their masks (the program never sees a codeword before its loss); for a send
mix, the source. It digests every pool frame, then warms up by one call on
each pool batch. A simulation mix (``POOL = "sim"``) holds no values: its
pool is the call indices 0..P-1 of the program's simulation step, seeded by
the run's seed, each of which draws and decodes its own batches, the same
work at every visit.

The window is a closed loop with one batch in flight, for ``--seconds`` and at
least once round the pool: a call of the entry on the next pool batch, then
one host sync at which the per-frame failure flags (a simulation's counters)
reach the host. A batch's time runs from its call to that sync (CUDA events
on the stream). Before
waiting, the harness enqueues the check's share of the call, behind the
batch's end: ``sample_frames`` of its frames, a digest of the symbols each
delivers and its erasures, each held on the card against what the frame's
previous call returned.

After the window: the peak memory, the pool's digests against set-up's, then
the reference (:mod:`codec_bench.reference`) draws the inputs again from the
seed, encodes them itself and decides which frames a decoder must recover. It
compares every flag the window returned, and the digest and erasures of every
frame sampled. For a simulation, the reference (:mod:`codec_bench.reference.sim`)
draws each pool call's masks again and works out its counters; every visit's
counters are compared with them. The guard against JAX comes last, after the
metric readers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import importlib.util
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from codec_bench import digest, faults, port, trace, traffic
from codec_bench.reference import codes as ref_codes
from codec_bench.reference import recovery
from codec_bench.reference import sim as ref_sim

BENCH_ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_ROOT)
# Top-level module names no run may load: JAX and the JAX package, which the
# program's own name starts with, so names are compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_erasure_codes_tpu")
# What torch warns for each host sync in "warn" mode (not its one-time notice
# on switching the mode on). Copied from ``rs/stream.py::SYNC_WARNING``.
SYNC_WARNING = "called a synchronizing CUDA operation"
CHECKS = ("flag_mismatch", "value_mismatch", "value_unstable", "erasure_mismatch",
          "input_mismatch", "pool_changed", "batches_unchecked")
SIM_CHECKS = ("stats_mismatch", "batches_unchecked")
REF_BLOCK_BYTES = 256 << 20


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    mix: object

    @classmethod
    def load(cls, root: str, name: str) -> "Cell":
        workload = load_json(root, "workloads", f"{name}.json")
        config = load_json(root, "configs", f"{workload['config']}.json")
        t = traffic.load(root, workload["traffic"])
        mix = load_module(os.path.join(root, "mixes", f"{t['mix']}.py"), f"codec_bench_mix_{t['mix']}")
        return cls(name, config, t, mix)


def metric_readers(root: str) -> dict:
    readers = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.py"))):
        name = os.path.basename(path)[: -len(".py")]
        if not name.startswith("_"):
            readers[name] = load_module(path, f"codec_bench_metric_{name.replace('.', '_')}")
    return readers


@dataclasses.dataclass
class RunView:
    """What a per-layer reader sees of a traced run."""

    layer: str
    batch: int
    n: int
    k: int
    words: int
    device_kind: str
    trace: trace.Summary | None
    syncs_per_call: float | None

    def calls(self, layer: str) -> int:
        return 0 if self.trace is None else self.trace.range_calls.get(layer, 0)

    def layer_device_s(self, layer: str) -> float | None:
        """Device seconds inside ``layer``'s calls, None where there were none."""
        if self.layer != layer or not self.calls(layer):
            return None
        return self.trace.range_device_s.get(layer, 0.0) or None


class SyncCounter:
    """Counts the host syncs that torch's sync debug mode warns of."""

    def __init__(self):
        self.count = 0

    def _hook(self, message, *args, **kwargs):
        if SYNC_WARNING in str(message):
            self.count += 1

    @contextlib.contextmanager
    def counting(self):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")


class Clock:
    """A batch's milliseconds from its call to its sync: CUDA events on the
    stream, or the host clock on the CPU (rehearsals only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def mark(self) -> None:
        """The batch's end, after its last operation on the stream."""
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def wait(self) -> float:
        """Wait for the mark; the batch's milliseconds."""
        if self.cuda:
            self.end.synchronize()
            return self.begin.elapsed_time(self.end)
        return 1e3 * (self.t1 - self.t0)


class Sampler:
    """Hands ``sample_frames`` frames of each call to the check: visit v of
    pool batch j takes row ``v % rows`` of its seeded slots, so the visits
    cover every frame. Keeps each frame's latest digest and erasures, and
    counts on the card the frames whose digest or erasures differ from what
    an earlier call returned for them (``unstable``)."""

    def __init__(self, cell: Cell, seed: int, mult: torch.Tensor, device: torch.device):
        t = cell.traffic
        b, n, k = t["batch"], cell.config["code"]["n"], cell.config["code"]["k"]
        p = t["pool_batches"]
        self.mult = mult
        self.slots = [traffic.sample_slots(seed, j, b, t["sample_frames"]) for j in range(p)]
        self.slots_dev = [torch.from_numpy(s).to(device) for s in self.slots]
        self.digests = torch.zeros((p, b), dtype=torch.int64, device=device)
        self.rx = cell.mix.POOL == "rx"
        self.erased = torch.zeros((p, b, n) if self.rx else (1,), dtype=torch.bool, device=device)
        delivered = k if getattr(cell.mix, "DELIVERS", "all") == "first_k" else n
        self.region = torch.arange(n, device=device) < delivered
        self.seen = torch.zeros((p, b), dtype=torch.bool, device=device)
        self.unstable = torch.zeros((), dtype=torch.int64, device=device)
        self.reset()

    def reset(self) -> None:
        """A new count of what the window covers; what earlier calls
        returned stays, to hold the window's calls against."""
        self.covered = np.zeros(self.digests.shape, dtype=bool)
        self.visits = [0] * len(self.slots)

    def take(self, j: int, out: port.Out) -> None:
        row = self.visits[j] % len(self.slots[j])
        idx = self.slots_dev[j][row]
        known = None
        if self.rx:
            er = out.erased.index_select(0, idx)
            known = ~er & self.region
        d = digest.frames(out.values.index_select(0, idx), self.mult, known)
        moved = d != self.digests[j].index_select(0, idx)
        if self.rx:
            moved |= (er != self.erased[j].index_select(0, idx)).any(dim=1)
            self.erased[j].index_copy_(0, idx, er)
        self.unstable += (moved & self.seen[j].index_select(0, idx)).sum()
        self.seen[j].index_fill_(0, idx, True)
        self.digests[j].index_copy_(0, idx, d)
        self.covered[j, self.slots[j][row]] = True
        self.visits[j] += 1


def build_pool(cell: Cell, state, seed: int, mult: torch.Tensor, device) -> tuple[list, list]:
    """The pool's batches and each frame's set-up digests (values, mask)."""
    t, code = cell.traffic, cell.config["code"]
    b, words = t["batch"], cell.config["symbol_bytes"] // 4
    pool, digests = [], []
    for j in range(t["pool_batches"]):
        src = traffic.source(seed, j, (b, code["k"], words), device)
        if cell.mix.POOL == "tx":
            pool.append((src,))
            digests.append((digest.in_blocks(src, mult), None))
            continue
        received = port.encode(cell.config, state.arrays, src)
        del src
        lost = traffic.loss(t["loss"], seed, j, t["pool_batches"], (b, code["n"]), device)
        received.masked_fill_(lost[:, :, None], 0)
        pool.append((received, lost))
        digests.append((digest.in_blocks(received, mult), digest.mask(lost, mult)))
    return pool, digests


def pool_changed(pool: list, digests: list, mult: torch.Tensor) -> int:
    changed = 0
    for batch, (values_d, mask_d) in zip(pool, digests):
        now = digest.in_blocks(batch[0], mult) != values_d
        if mask_d is not None:
            now |= digest.mask(batch[1], mult) != mask_d
        changed += int(now.sum())
    return changed


def reference_check(cell: Cell, root: str, seed: int, mult, sampler: Sampler, digests: list,
                    flags: list, device) -> dict:
    """The check's counts, from the reference alone and what the window kept."""
    t, code_cfg = cell.traffic, cell.config["code"]
    b, n, k, words = t["batch"], code_cfg["n"], code_cfg["k"], cell.config["symbol_bytes"] // 4
    code = ref_codes.load(code_cfg, root)
    block = max(1, REF_BLOCK_BYTES // (n * words * 4))
    out = dict.fromkeys(CHECKS, 0)
    rx = cell.mix.POOL == "rx"
    for j in range(t["pool_batches"]):
        src = traffic.source(seed, j, (b, k, words), device)
        lost = traffic.loss(t["loss"], seed, j, t["pool_batches"], (b, n), device) if rx else None
        covered = torch.from_numpy(sampler.covered[j]).to(device)
        for s in range(0, b, block):
            e = min(b, s + block)
            cw = code.codewords(src[s:e])
            if rx:
                sent = digest.frames(cw.masked_fill(lost[s:e, :, None], 0), mult)
                inputs_ok = ((sent == digests[j][0][s:e])
                             & (digest.mask(lost[s:e], mult) == digests[j][1][s:e]))
                known = ~sampler.erased[j][s:e] & sampler.region
            else:
                inputs_ok = digest.frames(src[s:e], mult) == digests[j][0][s:e]
                known = None
            out["input_mismatch"] += int((~inputs_ok).sum())
            wrong = digest.frames(cw, mult, known) != sampler.digests[j][s:e]
            out["value_mismatch"] += int((wrong & covered[s:e]).sum())
        if rx:
            ok, left = recovery.recoverable(cell.mix.RECOVERY, code, lost, k)
            ref_failed = (~ok).cpu().numpy()
            out["flag_mismatch"] += sum(int((f != ref_failed).sum()) for f in flags[j])
            er = sampler.erased[j]
            if left is not None:
                bad = (er[:, :k] != left[:, :k]).any(dim=1)
            else:
                bad = ok & (er & sampler.region).any(dim=1)
            out["erasure_mismatch"] += int((bad & covered).sum())
        out["batches_unchecked"] += int(not sampler.covered[j].any())
    if not rx:
        del out["erasure_mismatch"]
    return out


def sim_check(cell: Cell, root: str, seed: int, visits: list, device) -> tuple[dict, np.ndarray]:
    """The check's counts for a simulation mix, and the reference's counters
    summed over the pool's calls."""
    ref = ref_sim.Campaign(cell.traffic, cell.config, root, device)
    out = dict.fromkeys(SIM_CHECKS, 0)
    total = 0
    for j, got in enumerate(visits):
        want = ref.counters(seed, j)
        total = total + want
        out["stats_mismatch"] += sum(int(not np.array_equal(v, want)) for v in got)
        out["batches_unchecked"] += int(not got)
    return out, total


def sim_summary(total: np.ndarray, pool_calls: int) -> str:
    """FER, RS window FER and mean iterations over the pool's calls."""
    c = dict(zip(ref_sim.FIELDS, total))
    hist = total[len(ref_sim.FIELDS) - 1:]
    return (f"over the pool's {pool_calls} calls ({c['frames']} frames): FER "
            f"{c['block_errors'] / c['frames']:.6g} ({c['block_errors']} block errors), RS window "
            f"FER {c['rs_block_errors'] / max(c['rs_blocks'], 1):.6g}, mean iterations "
            f"{float(np.arange(len(hist)) @ hist) / max(hist.sum(), 1):.6g}")


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def run_cell(name: str, *, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, root: str = BENCH_ROOT, fault: str | None = None,
             trace_dir: str | None = None, log=sys.stderr) -> dict:
    """Run cell ``name`` once; returns the result line's object. On the CPU
    (a rehearsal) it reports no metric."""
    marks = [("start", time.perf_counter())]
    cell = Cell.load(root, name)
    port.check_code_files(cell.config, root, REPO_ROOT)
    t, code_cfg = cell.traffic, cell.config["code"]
    b, n, k = t["batch"], code_cfg["n"], code_cfg["k"]
    words = cell.config["symbol_bytes"] // 4
    sim = cell.mix.POOL == "sim"
    pinned = device.type == "cuda"
    if sim:
        state = cell.mix.setup(cell.config, device, t, seed)
        marks.append(("program", time.perf_counter()))
        pool, sampler = [(j,) for j in range(t["pool_calls"])], None
        # The eight scalar counters, then the max_iters + 1 bins of the histogram.
        host_flags = torch.empty((len(ref_sim.FIELDS) + t["decoder"]["max_iters"],),
                                 dtype=torch.int64, pin_memory=pinned)
    else:
        state = cell.mix.setup(cell.config, device)
        marks.append(("program", time.perf_counter()))
        mult = digest.multipliers(n, words, device)
        pool, digests = build_pool(cell, state, seed, mult, device)
        sampler = Sampler(cell, seed, mult, device)
        host_flags = torch.empty((b,), dtype=torch.bool, pin_memory=pinned)
    marks.append(("pool", time.perf_counter()))
    entry = faults.wrap(fault, cell.mix, state) if fault else (lambda *x: cell.mix.call(state, *x))
    clock = Clock(device)
    syncs = SyncCounter() if traced and device.type == "cuda" else None
    rf = torch.profiler.record_function

    def step(j: int, sample: bool = True) -> tuple[float, np.ndarray | None]:
        inputs = pool[j]
        clock.start()
        with rf(cell.mix.LAYER), (syncs.counting() if syncs else contextlib.nullcontext()):
            out = entry(*inputs)
        with rf("codec.sync"):
            fl = cell.mix.failed(state, out)
            if fl is not None:
                host_flags.copy_(fl, non_blocking=pinned)
            clock.mark()
        if sample and sampler:  # enqueued behind the mark, while the card still works
            with rf("codec.check"):
                sampler.take(j, out)
        with rf("codec.sync"):
            ms = clock.wait()
        return ms, None if fl is None else host_flags.numpy().copy()

    for j in range(len(pool)):  # warm-up: each pool batch once
        step(j)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if sampler:
        sampler.reset()
    if syncs:
        syncs.count = 0
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: before " + f"{marks[0][1] - t_start:.3f} s, " + ", ".join(
        f"{m} {t1 - t0:.3f} s" for (_, t0), (m, t1) in zip(marks, marks[1:])), file=log)

    flags: list[list] = [[] for _ in pool]
    lat: list[float] = []
    profiler = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if traced and device.type == "cuda" else contextlib.nullcontext())
    with profiler as prof:
        t0 = time.perf_counter()
        with rf(trace.WINDOW):
            while True:
                j = len(lat) % len(pool)
                ms, fl = step(j)
                lat.append(ms)
                flags[j].append(fl)
                if time.perf_counter() - t0 >= seconds and len(lat) >= len(pool):
                    break
        t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = trace.summarize(prof.profiler.kineto_results.events()) if prof is not None else None
    syncs_per_call = syncs.count / len(lat) if syncs else None
    if prof is not None and trace_dir:
        export_slice(step, len(pool), trace_dir, name, seed)
    changed = 0 if sim else pool_changed(pool, digests, mult)
    del pool, state, entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if sim:
        checks, total = sim_check(cell, root, seed, flags, device)
    else:
        checks = reference_check(cell, root, seed, mult, sampler, digests, flags, device)
        checks["pool_changed"] = changed
        checks["value_unstable"] = int(sampler.unstable)
    t_check = time.perf_counter() - t_check

    batches = len(lat)
    window_s = t1 - t0
    frames = batches * b * t.get("steps_per_call", 1)
    if sim:
        print(f"cell {name} seed {seed}: {batches} calls of {frames // batches} frames in "
              f"{window_s:.3f} s; set-up {t0 - t_start:.3f} s; {sim_summary(total, len(flags))}; "
              f"the reference took {t_check:.3f} s", file=log)
    else:
        flagged = sum(int(f.sum()) for fs in flags for f in fs if f is not None)
        print(f"cell {name} seed {seed}: {batches} batches of {b} frames in {window_s:.3f} s; "
              f"set-up {t0 - t_start:.3f} s; FER {flagged / frames:.6g} ({flagged} of {frames} "
              f"frames flagged); frames compared {int(sampler.covered.sum())} of "
              f"{sampler.covered.size} in the pool; the reference took {t_check:.3f} s", file=log)
    q = np.percentile(lat, [5, 25, 50, 75, 95])
    print("batch ms: p5 {:.4f} p25 {:.4f} p50 {:.4f} p75 {:.4f} p95 {:.4f}; wall per batch {:.4f} ms"
          .format(*q, 1e3 * window_s / batches), file=log)
    metrics = {}
    if device.type == "cuda" and not traced:
        metrics = {
            "info_gbps": {"value": frames * k * 8 * cell.config["symbol_bytes"] / window_s / 1e9,
                          "unit": "Gbps"},
            "batch_p95_ms": {"value": float(np.percentile(lat, 95)), "unit": "ms"},
            "setup_s": {"value": t0 - t_start, "unit": "s"},
        }
    dev = device_info(device, peak)
    failed = (checks["stats_mismatch"] if sim else checks["flag_mismatch"]
              + checks["value_mismatch"] + checks["value_unstable"]
              + checks.get("erasure_mismatch", 0))
    result = {"correct": all(v == 0 for v in checks.values()), "attempted": frames,
              "failed": failed, "metrics": metrics, "device": dev}
    readers = metric_readers(root)
    if summary is not None:
        view = RunView(cell.mix.LAYER, b, n, k, words, dev["kind"], summary, syncs_per_call)
        for metric, reader in readers.items():
            value = reader.read(view)
            if value is not None:
                metrics[metric] = {"value": value, "unit": reader.UNIT}
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    for metric, v in metrics.items():
        print(f"metric {metric} {v['value']!r} {v['unit']}", file=log)
    for check, v in checks.items():
        print(f"check {check} {v} limit 0", file=log)
    result["checks"] = {c: {"value": v, "limit": 0} for c, v in checks.items()}
    found = forbidden_modules()  # last: after the reference and the readers
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
    return result


def export_slice(step, pool_batches: int, trace_dir: str, name: str, seed: int) -> None:
    """A Chrome trace of two batches, for reading by eye."""
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as p:
        for j in range(min(2, pool_batches)):
            step(j, sample=False)
    p.export_chrome_trace(os.path.join(trace_dir, f"{name}.seed{seed}.json"))
