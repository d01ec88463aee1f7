"""Multi-process worker: one OS process of a distributed run.

Counterpart of ``ldpc_erasure_codes_tpu/parallel/_mp_worker.py``. Run as
``python -m ldpc_erasure_codes_tpu_torch.parallel._mp_worker`` once per
process (see tests/test_torch_parallel.py). Each worker

1. joins the process group (:func:`.multihost.initialize`: NCCL on its card,
   or gloo with ``--device cpu``) at ``--init-method`` (``file://...`` or
   ``tcp://host:port``; ``--coordinator host:port`` is ``tcp://host:port``),
2. builds the 1-D data mesh over every rank (one device per process, where
   the JAX worker took ``--local-devices`` virtual devices),
3. runs ``--steps`` calls of the sharded Monte-Carlo step (rank r draws
   shard r's streams, the statistics summed with ``all_reduce``), and
4. writes the summed SimStats as JSON (``info``, ``mesh_devices``, ``stats``).

Every rank must report identical numbers, equal to the sum of single-process
runs of each shard's streams.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    where = p.add_mutually_exclusive_group(required=True)
    where.add_argument("--coordinator", help="host:port (tcp)")
    where.add_argument("--init-method", help="file://path or tcp://host:port")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", required=True, help="JSON output path")
    p.add_argument("--code", default="n2000_k1000")
    p.add_argument("--batch", type=int, default=32, help="per-DEVICE batch")
    p.add_argument("--per", type=float, default=0.3)
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)

    from ldpc_erasure_codes_tpu_torch.codes.io import get_code
    from ldpc_erasure_codes_tpu_torch.parallel import multihost
    from ldpc_erasure_codes_tpu_torch.parallel.mesh import shard_sim_step
    from ldpc_erasure_codes_tpu_torch.sim import DecoderConfig, SimConfig
    from ldpc_erasure_codes_tpu_torch.sim.driver import make_sim_step

    multihost.initialize(
        args.device,
        init_method=args.init_method or f"tcp://{args.coordinator}",
        world_size=args.num_processes,
        rank=args.process_id,
    )
    try:
        info = multihost.process_info()
        mesh = multihost.global_mesh()
        cfg = SimConfig(
            code=args.code,
            batch=args.batch,
            track_values=False,
            decoder=DecoderConfig(kind="peel", max_iters=20, early_stop_k=True),
        )
        step = shard_sim_step(
            make_sim_step(get_code(args.code), cfg, device=multihost.device()), mesh)
        total = None
        for i in range(args.steps):
            stats = step(i, args.per)
            total = stats if total is None else total + stats
        host = total.to_host()
        payload = {
            "info": info,
            "mesh_devices": mesh.size(),
            "stats": {k: v for k, v in host._asdict().items()},
        }
    finally:
        multihost.shutdown()
    with open(args.out, "w") as f:
        json.dump(payload, f)
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
