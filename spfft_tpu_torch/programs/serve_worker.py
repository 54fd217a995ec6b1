"""RPC serving worker: one host of a multi-host transform-serving fleet.

The port of ``programs/serve_worker.py``. Spawned by
:func:`spfft_tpu_torch.hostmesh.spawn_workers` (or by hand): optionally joins
a ``torch.distributed`` run, warm-starts tuning wisdom from the fleet bundle
(``SPFFT_TPU_HOSTS_WISDOM_BUNDLE``), stands up a
:class:`~spfft_tpu_torch.serve.TransformService` behind an
:class:`~spfft_tpu_torch.serve.RpcServer`, and writes a ready file naming the
bound port, the parent's boot handshake. Every ``SPFFT_TPU_*`` knob arrives
through the environment (``hostmesh.child_env`` propagates the parent's).

The service runs on the card unless ``--device cpu`` is given; with no CUDA
device the worker fails to boot (``GPUNoDeviceError``), it never serves on
the CPU unasked. ``--dtype`` is the service's plans' dtype (default
float64, the port's ``dtype=None``).

Exits cleanly on the RPC ``shutdown`` op; a SIGKILL is the chaos scenario
the cluster front's heartbeat and host-lost ladder exist for.

    python -m spfft_tpu_torch.programs.serve_worker --host-id 0 --port 0 \\
        --ready-file w0.json [--device cpu] [--dtype float32]
        [--coordinator host:port --num-processes N --process-id I]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--port", type=int, default=0,
                   help="RPC listen port (0 = OS-assigned)")
    p.add_argument("--ready-file", default=None,
                   help="write a JSON ready record here once serving")
    p.add_argument("--device", choices=["gpu", "cpu"], default="gpu",
                   help="where the service runs (default: the card)")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed coordinator host:port (joins a "
                   "multi-process run when given)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from spfft_tpu_torch import ProcessingUnit, hostmesh
    from spfft_tpu_torch.serve import TransformService
    from spfft_tpu_torch.serve.rpc import RpcServer

    topology = None
    if args.coordinator is not None:
        topology = hostmesh.boot(
            args.coordinator, args.num_processes, args.process_id,
            backend="nccl" if args.device == "gpu" else "gloo",
        )
    warm = hostmesh.warm_start()

    shutdown = threading.Event()
    pu = ProcessingUnit.GPU if args.device == "gpu" else ProcessingUnit.HOST
    service = TransformService(pu, dtype=np.dtype(args.dtype), start=True)
    server = RpcServer(service, port=args.port, on_shutdown=shutdown.set)

    ready = {
        "host_id": int(args.host_id),
        "pid": os.getpid(),
        "port": server.port,
        "device": str(service._device),
        "dtype": args.dtype,
        "wisdom_warm_start": list(warm),
        "topology": topology,
        "env_knobs": sorted(k for k in os.environ if k.startswith("SPFFT_TPU_")),
    }
    if args.ready_file:
        tmp = Path(str(args.ready_file) + ".tmp")
        tmp.write_text(json.dumps(ready, indent=1))
        tmp.rename(args.ready_file)  # atomic: the parent never reads a torn file
    print(f"SPFFT_WORKER_READY {json.dumps(ready)}", flush=True)

    # serve until a peer sends the shutdown op (bounded waits: the loop
    # re-checks twice a second so signals/KeyboardInterrupt land promptly)
    try:
        while not shutdown.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.close()
    service.close(drain=False)
    if topology is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
