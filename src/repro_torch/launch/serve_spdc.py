"""SPDC gateway launcher: drive the async micro-batching determinant
service with a synthetic open-loop client workload (port of
repro.launch.serve_spdc).

    PYTHONPATH=src python -m repro_torch.launch.serve_spdc --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_spdc --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_spdc \
        --servers 4 --requests 256 --rate 200 --sizes 24,48,96 \
        --max-batch 32 --max-wait-us 2000 \
        --tenants 4 --tenant-rate 100 --health-port 9100

Open-loop means arrivals are paced by the offered rate, not by service
completions (`--rate 0` = saturating: all requests arrive at once), so
queueing delay shows up in the reported p50/p99 latency exactly as it
would for independent IoT clients. Each request draws its size from
--sizes; the gateway buckets mixed sizes, coalesces each bucket into one
batched protocol sweep, and answers with a per-request verdict.

Production-hardening surface (DESIGN.md §10): --tenants spreads the swarm
over synthetic tenants, --tenant-rate/--tenant-burst/--tenant-max-pending
turn on per-tenant admission control, --no-breaker/--no-cache disable the
per-bucket circuit breakers and the idempotency result cache, and
--health-port serves GET /healthz and GET /metrics (Prometheus text) from
the live gateway on 127.0.0.1 for the run's duration (port 0 picks a free
port). --smoke self-fetches both endpoints once to prove the surface.

--device: where the gateway computes. Without it the run is on the CUDA
device and raises where there is none; the CPU (the kernels' plain
versions) only with ``--device cpu``. The reference's x64 switch has no
counterpart: torch computes float64 wherever it is asked to.

--check verifies every returned determinant against torch.linalg.slogdet
in float64 at rtol 1e-10, and every solve against torch.linalg.solve,
on the run's device (always on with --smoke).
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import threading
import time

import numpy as np
import torch


def parse_sizes(spec: str) -> tuple[int, ...]:
    sizes = tuple(int(s) for s in spec.split(",") if s)
    if not sizes or any(s < 2 for s in sizes):
        raise argparse.ArgumentTypeError(f"bad --sizes {spec!r}")
    return sizes


def percentile_ms(lat_s: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat_s), q) * 1e3)


def parse_ops(spec: str) -> tuple[str, ...]:
    ops = tuple(s for s in spec.split(",") if s)
    bad = set(ops) - {"det", "slogdet", "solve"}
    if not ops or bad:
        raise argparse.ArgumentTypeError(f"bad --ops {spec!r}")
    return ops


async def run_workload(gw, mats, arrival_s, tenants=None, ops=None,
                       rhss=None):
    """Submit each matrix at its open-loop arrival time; gather results.

    Returns (results, rejected_by_kind, wall_s). Shed requests leave None
    in their results slot and count under their typed rejection kind.
    `ops`/`rhss` carry each request's secure-linalg op and (for solve)
    its right-hand side; None means all-determinant.
    """
    from ..serve import AdmissionRejected, BreakerOpen, GatewayOverloaded

    t0 = time.perf_counter()
    results = [None] * len(mats)
    rejected = {"overload": 0, "admission": 0, "breaker": 0}

    async def one(i):
        delay = arrival_s[i] - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        kwargs = {"tenant": tenants[i]} if tenants is not None else {}
        if ops is not None:
            kwargs["op"] = ops[i]
            if ops[i] == "solve":
                kwargs["rhs"] = rhss[i]
        try:
            results[i] = await gw.submit(mats[i], **kwargs)
        except GatewayOverloaded:
            rejected["overload"] += 1
        except AdmissionRejected:
            rejected["admission"] += 1
        except BreakerOpen:
            rejected["breaker"] += 1

    await asyncio.gather(*(one(i) for i in range(len(mats))))
    wall = time.perf_counter() - t0
    return results, rejected, wall


def start_health_server(gw, port: int):
    """Serve GET /healthz and GET /metrics from the live gateway.

    Returns the ThreadingHTTPServer (bound to 127.0.0.1; ``port`` 0 picks
    a free one — read it back from ``server_address[1]``). The caller
    shuts it down.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/healthz":
                verdict = gw.healthz()
                body = "".join(f"{k}: {v}\n" for k, v in verdict.items())
                code = 503 if verdict["status"] == "overloaded" else 200
            elif self.path == "/metrics":
                body, code = gw.render_metrics(), 200
            else:
                body, code = "not found\n", 404
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):  # keep the workload output clean
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _self_check_health(port: int) -> None:
    """Fetch both endpoints once (the --smoke proof that the surface
    actually serves, not merely that the thread started)."""
    from urllib.request import urlopen

    with urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        health = r.read().decode()
        assert health.startswith("status: "), health
    with urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        metrics = r.read().decode()
        assert "spdc_gateway_served_total" in metrics, metrics[:200]
    print(f"  health: GET /healthz -> {health.splitlines()[0]!r}, "
          f"GET /metrics -> {len(metrics.splitlines())} series lines")


def check_answers(results, mats, rhss, device) -> tuple[int, int]:
    """Every served determinant against torch.linalg.slogdet in float64
    at rtol 1e-10 (the sign exact), every solve against
    torch.linalg.solve within 1e-8 relative, on `device`. Returns the
    counts checked (dets, solves); raises AssertionError on a mismatch."""
    n_det = n_solve = 0
    for i, (r, m) in enumerate(zip(results, mats, strict=True)):
        if r is None:
            continue
        a = torch.from_numpy(np.asarray(m, dtype=np.float64)).to(device)
        if r.op == "solve":
            b = torch.from_numpy(np.asarray(rhss[i], dtype=np.float64))
            want = torch.linalg.solve(a, b.to(device))
            got = torch.as_tensor(r.solution, dtype=torch.float64,
                                  device=device)
            err = float(torch.linalg.norm(got - want)
                        / torch.linalg.norm(want))
            assert err < 1e-8, \
                f"solve mismatch for request {r.rid} (n={r.n}): {err:.2e}"
            n_solve += 1
            continue
        ws, wl = (float(t) for t in torch.linalg.slogdet(a))
        if r.op == "slogdet":
            got_s, got_l = r.sign, r.logabs
        else:
            got_s, got_l = r.det.sign, r.det.logabs
        assert got_s == ws and np.isclose(got_l, wl, rtol=1e-10), \
            f"{r.op} mismatch for request {r.rid} (n={r.n})"
        n_det += 1
    return n_det, n_solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SPDC micro-batching gateway + synthetic client swarm"
    )
    ap.add_argument("--servers", type=int, default=2,
                    help="edge servers per sweep (N)")
    ap.add_argument("--requests", type=int, default=128,
                    help="total client requests to offer")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load, requests/sec (0 = saturating)")
    ap.add_argument("--sizes", type=parse_sizes, default=(24, 48, 96),
                    help="comma-separated raw matrix sizes clients draw from")
    ap.add_argument("--ops", type=parse_ops, default=("det",),
                    help="secure-linalg ops clients draw from (comma-"
                         "separated subset of det,slogdet,solve — "
                         "DESIGN.md §12); solve requests carry a random "
                         "right-hand side")
    ap.add_argument("--buckets", type=parse_sizes, default=None,
                    help="bucket sizes (default: preset buckets)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-us", type=float, default=2000.0)
    ap.add_argument("--max-pending", type=int, default=4096)
    ap.add_argument("--method", choices=["q1", "q2", "q3"], default="q3")
    ap.add_argument("--mode", choices=["ewd", "ewm"], default="ewd")
    ap.add_argument("--transport",
                    choices=["inline", "threadpool", "multiprocess",
                             "socket"],
                    default="inline",
                    help="execution boundary for bucket sweeps (DESIGN.md "
                         "§7/§9): inline = fused fast path; threadpool = "
                         "in-process edge workers; multiprocess = spawned "
                         "worker processes, wire-codec messages; socket = "
                         "warm worker daemons over TCP/UDS (self-hosted "
                         "local UDS fleet when no addresses are given)")
    ap.add_argument("--recover", action="store_true",
                    help="heal rejected verdicts in place (DESIGN.md §4)")
    ap.add_argument("--standby", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread the client swarm over this many tenants")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant admission rate, tokens/sec "
                         "(DESIGN.md §10.1; unset = no rate limit)")
    ap.add_argument("--tenant-burst", type=float, default=None,
                    help="per-tenant token-bucket burst (default: rate)")
    ap.add_argument("--tenant-max-pending", type=int, default=None,
                    help="per-tenant pending-request quota")
    ap.add_argument("--no-breaker", action="store_true",
                    help="disable per-bucket circuit breakers")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the idempotency result cache")
    ap.add_argument("--health-port", type=int, default=None,
                    help="serve GET /healthz + /metrics on 127.0.0.1:PORT "
                         "for the run (0 = pick a free port)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip priming the bucket sweeps")
    ap.add_argument("--check", action="store_true",
                    help="verify every det against torch.linalg.slogdet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + full checking (CI entry)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..configs import (
        ADMISSION_OFF,
        BREAKER_DEFAULT,
        BREAKER_OFF,
        CACHE_DEFAULT,
        CACHE_OFF,
        AdmissionConfig,
        SPDCConfig,
        SPDCGatewayConfig,
    )
    from ..device import resolve_device
    from ..serve import AsyncSPDCGateway

    device = resolve_device(args.device)
    if args.smoke:
        args.requests = min(args.requests, 24)
        args.sizes = (6, 10, 16)
        args.buckets = args.buckets or (16, 32)
        args.max_batch = min(args.max_batch, 8)
        args.check = True
        if args.ops == ("det",):
            # the smoke proves the whole secure-linalg family
            args.ops = ("det", "slogdet", "solve")
        if args.health_port is None:
            args.health_port = 0  # prove the health surface

    if (args.tenant_rate is not None or args.tenant_burst is not None
            or args.tenant_max_pending is not None):
        admission = AdmissionConfig(
            rate_per_sec=args.tenant_rate,
            burst=args.tenant_burst,
            max_pending_per_tenant=args.tenant_max_pending,
        )
    else:
        admission = ADMISSION_OFF

    spdc = SPDCConfig(
        num_servers=args.servers, mode=args.mode, method=args.method,
        recover=args.recover, standby=args.standby,
        transport=args.transport,
    )
    cfg = SPDCGatewayConfig(
        name="spdc-gateway-cli",
        buckets=args.buckets or SPDCGatewayConfig.buckets,
        max_batch=args.max_batch,
        max_wait_us=args.max_wait_us,
        max_pending=args.max_pending,
        spdc=spdc,
        admission=admission,
        breaker=BREAKER_OFF if args.no_breaker else BREAKER_DEFAULT,
        cache=CACHE_OFF if args.no_cache else CACHE_DEFAULT,
    )

    rng = np.random.default_rng(args.seed)
    sizes = rng.choice(args.sizes, size=args.requests)
    mats = [rng.standard_normal((n, n)) + n * np.eye(n) for n in sizes]
    ops = (
        [str(o) for o in rng.choice(args.ops, size=args.requests)]
        if tuple(args.ops) != ("det",) else None
    )
    rhss = (
        [rng.standard_normal(int(n)) if ops[i] == "solve" else None
         for i, n in enumerate(sizes)]
        if ops is not None else None
    )
    tenants = (
        [f"tenant{i % args.tenants}" for i in range(args.requests)]
        if args.tenants > 1 else None
    )
    if args.rate > 0:
        arrival_s = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    else:
        arrival_s = np.zeros(args.requests)

    async def drive():
        async with AsyncSPDCGateway(cfg, device=device) as gw:
            health_srv = None
            if args.health_port is not None:
                health_srv = start_health_server(gw, args.health_port)
                port = health_srv.server_address[1]
                print(f"[health] serving /healthz + /metrics on "
                      f"127.0.0.1:{port}")
            if args.warmup:
                t0 = time.perf_counter()
                primed = await gw.warmup()
                print(f"[warmup] {primed} bucket shapes primed in "
                      f"{time.perf_counter() - t0:.1f}s")
            results, rejected, wall = await run_workload(
                gw, mats, arrival_s, tenants, ops, rhss
            )
            health_checked = False
            if health_srv is not None:
                await asyncio.to_thread(
                    _self_check_health, health_srv.server_address[1]
                )
                health_checked = True
                health_srv.shutdown()
            return (results, rejected, wall, gw.stats.as_dict(),
                    gw.healthz(), health_checked)

    results, rejected, wall, stats, health, health_checked = (
        asyncio.run(drive())
    )
    served = [r for r in results if r is not None]
    n_rejected = sum(rejected.values())
    if not served:
        print("no requests served")
        return 1
    lats = [r.latency_s for r in served]
    rate_txt = f"{args.rate:.0f} req/s" if args.rate else "saturating"
    print(f"[serve_spdc] N={args.servers} offered={rate_txt} "
          f"requests={args.requests} sizes={tuple(args.sizes)} "
          f"device={device}"
          + (f" ops={tuple(args.ops)}" if ops is not None else "")
          + (f" tenants={args.tenants}" if args.tenants > 1 else ""))
    if ops is not None:
        mix = {o: sum(1 for r in served if r.op == o) for o in args.ops}
        print("  op mix served: "
              + " ".join(f"{o}={c}" for o, c in mix.items()))
    print(f"  served={len(served)} rejected={n_rejected} "
          f"(overload={rejected['overload']} "
          f"admission={rejected['admission']} "
          f"breaker={rejected['breaker']}) wall={wall:.2f}s "
          f"sustained={len(served) / wall:.1f} dets/sec")
    print(f"  latency p50={percentile_ms(lats, 50):.1f}ms "
          f"p99={percentile_ms(lats, 99):.1f}ms "
          f"max={max(lats) * 1e3:.1f}ms")
    print(f"  flushes={stats['flushes']} (full={stats['flushes_full']} "
          f"timeout={stats['flushes_timeout']} drain={stats['flushes_drain']}) "
          f"recovered={stats['recovered_flushes']} direct={stats['direct']}")
    print(f"  cache hits={stats['cache_hits']} "
          f"coalesced={stats['coalesced']} "
          f"breaker opens={stats['breaker_opens']} "
          f"health={health['status']}")

    failed = [r for r in served if not r.verified]
    if failed:
        print(f"  VERIFICATION FAILED for {len(failed)} requests")
        return 1
    if args.smoke and args.health_port is not None and not health_checked:
        print("  health surface was not exercised")
        return 1
    if args.check:
        n_det, n_solve = check_answers(results, mats, rhss, device)
        print(f"  check: all {n_det} dets match torch.linalg.slogdet at "
              "rtol 1e-10"
              + (f"; all {n_solve} solves within 1e-8 of torch.linalg.solve"
                 if n_solve else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
