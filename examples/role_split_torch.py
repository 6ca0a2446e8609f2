"""Role-split SPDC on the PyTorch port (DESIGN.md §7): drive the client
and the untrusted edge servers as separate objects, watch the wire
messages, and heal a tampering worker over a real process boundary.

    python examples/role_split_torch.py [--n 64] [--servers 4] [--multiprocess]
    python examples/role_split_torch.py --n 32 --device cpu

The twin of examples/role_split.py: the same flags and printed checks,
plus --device (default: the CUDA device; the workers compute there too).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import (
    EdgeServer, MultiprocessTransport, ServerFault, SPDCClient,
    ThreadPoolTransport,
)
from repro_torch.api import ShardResult


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--multiprocess", action="store_true",
                    help="spawn real worker processes (slower to start; "
                         "every message crosses an OS pipe as bytes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    dev = args.device

    rng = np.random.default_rng(0)
    m = rng.standard_normal((args.n, args.n)) + args.n * np.eye(args.n)
    want_s, want_la = np.linalg.slogdet(m)

    # --- the client role: all secrets live in the session -------------------
    client = SPDCClient(method="q2", device=dev)
    session = client.open_session(m, args.servers)
    tasks = session.tasks()
    frame = tasks[1].to_bytes()
    print(f"client: session {session.session_id} → {len(tasks)} ShardTasks")
    print(f"  task[1] on the wire: {len(frame)} bytes "
          f"(encrypted {tasks[1].x_row.shape} block row + 32-byte subseed; "
          "no plaintext, no key material)")

    # --- the server role: stateless workers, relay threaded by hand --------
    results, u_rows = [], []
    for task in tasks:
        if task.server > 0:  # the one-way S_{i-1} → S_i relay content
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        res = EdgeServer(task.server, device=dev).run(task)
        res = ShardResult.from_bytes(res.to_bytes())  # bytes, like a real wire
        results.append(res)
        u_rows.append(np.asarray(res.u_row))
    out = session.collect(results)
    assert out.verified and out.det.sign == want_s
    assert np.isclose(out.det.logabs, want_la, rtol=1e-9)
    print("  manual relay: verified, determinant recovered exactly")

    # --- same flow through a pluggable transport, with a tampering worker --
    transport_cls = MultiprocessTransport if args.multiprocess \
        else ThreadPoolTransport
    with transport_cls(device=dev) as tp:
        honest = SPDCClient(method="q2", device=dev).open_session(
            m, args.servers).run(tp)
        assert honest.verified
        hardened = SPDCClient(method="q2", recover=True, standby=1, device=dev)
        bad = hardened.open_session(
            m, args.servers,
            faults=ServerFault(server=1, mode="block", magnitude=0.3),
        ).run(tp)
        rep = bad.report.recovery
        assert bad.verified and rep.ok
        assert np.isclose(bad.det.logabs, honest.det.logabs, rtol=1e-10)
        print(f"  {tp.name} transport: worker 1 tampered in-band → localized, "
              f"healed in {rep.rounds} round(s) via re-dispatched ShardTasks "
              f"(servers {rep.servers_replaced}), det matches honest")


if __name__ == "__main__":
    main()
