"""Edge-gateway demo on the PyTorch port: many IoT clients, one
micro-batching SPDC service.

A swarm of clients each submits ONE matrix (mixed sizes, one tampering
edge server in the mix); the gateway buckets them by padded size, coalesces
each bucket into a single batched protocol sweep, heals the tampered
bucket in place, and answers every client with a verified determinant.

    python examples/edge_gateway_torch.py [--clients 24] [--servers 2]
    python examples/edge_gateway_torch.py --device cpu

The twin of examples/edge_gateway.py: the same flags and printed checks,
plus --device (default: the CUDA device).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import ServerFault, SPDCGateway
from repro_torch.configs import SPDCConfig, SPDCGatewayConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    cfg = SPDCGatewayConfig(
        name="demo-gateway",
        buckets=(16, 32, 64),
        max_batch=8,
        max_wait_us=2000.0,
        spdc=SPDCConfig(
            num_servers=args.servers, recover=True, standby=1,
        ),
    )

    # one edge server misbehaves, but only in the n'=32 bucket's sweeps
    def faults_for(key):
        if key.pad_to == 32:
            return ServerFault(server=args.servers - 1, kind="tamper")
        return None

    gw = SPDCGateway(cfg, faults_for=faults_for, device=args.device)
    rng = np.random.default_rng(0)
    sizes = rng.integers(4, 65, size=args.clients)
    mats = [rng.standard_normal((n, n)) + n * np.eye(n) for n in sizes]

    print(f"{args.clients} clients (sizes {sizes.min()}..{sizes.max()}) → "
          f"gateway → {args.servers} untrusted edge servers "
          f"(server {args.servers - 1} tampers with the n'=32 bucket)")
    rids = [gw.submit(m) for m in mats]
    gw.drain()

    healed = 0
    for m, rid in zip(mats, rids, strict=True):
        res = gw.take(rid)
        assert res is not None and res.verified, f"request {rid} failed"
        ws, wl = np.linalg.slogdet(m)
        assert res.det.sign == ws and np.isclose(res.det.logabs, wl,
                                                 rtol=1e-10)
        if res.recovery is not None:
            healed += 1
    s = gw.stats
    print(f"  served {s.served} requests in {s.flushes} coalesced sweeps "
          f"(full={s.flushes_full} timeout={s.flushes_timeout} "
          f"drain={s.flushes_drain})")
    print(f"  {s.recovered_flushes} sweep(s) healed a tampered server; "
          f"{healed} requests rode through recovery")
    print("  every determinant exact at rtol 1e-10; "
          "tampered buckets healed without touching clean ones. OK")


if __name__ == "__main__":
    main()
