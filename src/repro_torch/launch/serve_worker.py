"""SPDC edge-worker daemon launcher: one warm worker process a fleet of
clients can reach over TCP or a Unix-domain socket (DESIGN.md §9; port
of repro.launch.serve_worker).

    # serve ANY worker id on an ephemeral TCP port (printed on start),
    # computing on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.serve_worker --bind tcp://127.0.0.1:0

    # one daemon per worker identity, the paper's fleet shape, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_worker \
        --bind unix:///tmp/spdc-w0.sock --workers 0 --device cpu

    # client side
    from repro_torch.api import SPDCClient, TransportConfig
    client = SPDCClient(transport=TransportConfig(
        "socket", addresses=("tcp://127.0.0.1:45123",)))

The daemon holds this process's EdgeServers — and its loaded kernels
and device context — warm across every connection, session, and client
restart. On a CUDA device it builds (or loads) the kernels and creates
the device context before it binds, so the first request pays no nvcc.
Worker ids map onto daemons client-side as
``addresses[i % len(addresses)]``, so one daemon serving "any id" can
stand in for a whole fleet, and recovery's replacement ids wrap onto
the same endpoints.

--device: where the daemon computes. Without it the daemon runs on the
CUDA device and raises where there is none; it never carries on on the
CPU unless given ``--device cpu``. The reference's ``--no-x64`` is not
carried over: in torch each frame's arrays carry their dtype, so one
daemon serves float64 and float32 sessions alike, and there is no
process-wide precision switch to set.

--smoke starts a UDS daemon, runs one small verified determinant through
it over a real SocketTransport, and exits — the runnable quickstart.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_workers(spec: str | None):
    if spec is None or spec == "":
        return None
    try:
        return tuple(int(s) for s in spec.split(",") if s != "")
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--workers wants comma-separated ints, got {spec!r}"
        ) from None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="warm SPDC edge-worker daemon (TCP or Unix socket)"
    )
    ap.add_argument("--bind", default="tcp://127.0.0.1:0",
                    help="tcp://host:port (port 0 = ephemeral, printed) "
                         "or unix:///path.sock")
    ap.add_argument("--workers", type=parse_workers, default=None,
                    help="comma-separated worker ids this daemon serves "
                         "(default: any id)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--smoke", action="store_true",
                    help="self-test: UDS daemon + one verified "
                         "determinant over SocketTransport, then exit")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.smoke:
        return smoke(device)

    from ..api.socket_transport import WorkerDaemon

    daemon = WorkerDaemon(args.bind, workers=args.workers, device=device)
    addr = daemon.start()
    served = "any" if args.workers is None else ",".join(
        str(w) for w in args.workers
    )
    print(f"[serve_worker] listening on {addr} workers={served} "
          f"device={device}", flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.close()
    return 0


def smoke(device) -> int:
    """Daemon + client in one process: the quickstart, executably."""
    import numpy as np

    from ..api import SPDCClient, TransportConfig
    from ..api.socket_transport import WorkerDaemon

    with tempfile.TemporaryDirectory(prefix="spdc-smoke-") as tmp, \
            WorkerDaemon(f"unix://{os.path.join(tmp, 'w.sock')}",
                         device=device) as daemon:
        cfg = TransportConfig("socket", addresses=(daemon.address,))
        rng = np.random.default_rng(7)
        x = rng.standard_normal((48, 48)) + 48 * np.eye(48)
        with SPDCClient(transport=cfg, device=device) as client:
            sess = client.open_session(x, num_servers=2)
            res = sess.run(client.transport)
            hello = client.transport.hello(0)
        ws, wl = np.linalg.slogdet(x)
        ok = (res.verified and res.det.sign == ws
              and np.isclose(res.det.logabs, wl, rtol=1e-10))
        print(f"[serve_worker --smoke] addr={daemon.address} "
              f"device={device} verified={res.verified} "
              f"det matches slogdet={ok} "
              f"daemon connections={hello['connections'] if hello else '?'}")
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
