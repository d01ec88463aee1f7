"""Run one cell of the codec benchmark once and print its result line.

    python3 -m codec_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``ldpc_erasure_codes_tpu_torch``. It
needs a CUDA card and never falls back to the CPU. The last line of standard
output is the result as one JSON object; the numbers the check compared,
each beside its limit, are the last lines of standard error.

``--fault`` puts the control (``half_width``) or a fault of
:mod:`codec_bench.faults` in the entry's place; the check has to fail it. A
traced run also keeps a Chrome trace of two batches, after the window
(``--trace-dir``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="where a traced run keeps its Chrome trace of two batches "
                        "(default: $TMPDIR/codec_bench_traces, else codec_bench_traces/ "
                        "in the checkout)")
    args = p.parse_args(argv)

    import torch

    from codec_bench import harness

    cell = harness.load_json(harness.BENCH_ROOT, "workloads", f"{args.workload}.json")
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"codec_bench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    trace_dir = args.trace_dir or os.path.join(
        os.environ.get("TMPDIR") or harness.REPO_ROOT, "codec_bench_traces")
    result = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                              traced=bool(args.trace), device=device, t_start=T_START,
                              fault=args.fault, trace_dir=trace_dir)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
