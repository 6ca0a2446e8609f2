"""Rateless fleet demo on the PyTorch port: a straggling server and a
tampering server, no deadline anywhere — the scheduler streams
over-decomposed strips to whoever is free, the straggler just does less,
and the tamperer is caught by a per-strip secret probe and quarantined
(DESIGN.md §8).

    python examples/rateless_fleet_torch.py [--n 64] [--batch 6]
    python examples/rateless_fleet_torch.py --device cpu

The twin of examples/rateless_fleet.py: the same flags and printed
checks, plus --device (default: the CUDA device).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import RatelessConfig, ServerFault, SPDCClient, ThreadPoolTransport

N = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    dev = args.device

    rng = np.random.default_rng(7)
    stack = (rng.standard_normal((args.batch, args.n, args.n))
             + args.n * np.eye(args.n))
    want_sign, want_log = np.linalg.slogdet(stack)

    # server 1 straggles (heavy Pareto tail — the case deadlines handle
    # worst); server 2 tampers with every block row it computes
    plan = (
        ServerFault(server=1, kind="delay", delay_s=0.3,
                    delay_dist="pareto", delay_alpha=2.5),
        ServerFault(server=2, kind="tamper", mode="block", magnitude=0.5),
    )
    cfg = RatelessConfig(request_timeout_s=0.5)
    client = SPDCClient(rateless=cfg, device=dev)

    print(f"Outsourcing {args.batch} determinants ({args.n}x{args.n}) to "
          f"{N} edge servers: server 1 straggling, server 2 tampering,")
    print(f"no straggler deadline — F = {cfg.overdecompose}*{N} rateless "
          f"strips per matrix, streamed to whoever is free")
    with ThreadPoolTransport(device=dev) as tp:
        # honest pass on a throwaway client: warms each strip shape's
        # kernels once, so the faulted run's timeouts measure the FLEET,
        # not the first launches
        honest_res = SPDCClient(rateless=cfg, device=dev).open_session(
            stack, N).run(tp)
        honest_done = [w["completed"]
                       for w in honest_res.report.fleet.workers.values()]
        print(f"warmup (honest fleet): strips per server = "
              f"{sorted(honest_done, reverse=True)}")
        res = client.open_session(stack, N, faults=plan).run(tp)

    fleet = res.report.fleet
    print(f"\n  verified          = {np.asarray(res.verified).tolist()}")
    print(f"  strips x lanes    = {fleet.num_strips} x {fleet.lanes} "
          f"({fleet.dispatches} dispatches, {fleet.retries} retries, "
          f"{fleet.timeouts} timeouts)")
    for wid in sorted(fleet.workers):
        w = fleet.workers[wid]
        role = {1: "  <- straggler", 2: "  <- tamperer"}.get(wid, "")
        ewma = w["ewma_latency_s"]
        ewma_ms = f"{ewma * 1e3:7.1f} ms" if ewma is not None else "      --- "
        print(f"  server {wid}: completed {w['completed']:3d}  "
              f"ewma {ewma_ms}  tampers {w['tampers']}  "
              f"quarantined={w['quarantined']}{role}")

    assert bool(np.all(res.verified))
    got_sign = np.asarray([d.sign for d in res.dets])
    got_log = np.asarray([d.logabs for d in res.dets])
    assert np.array_equal(got_sign, want_sign)
    assert np.allclose(got_log, want_log, rtol=1e-9)
    honest = [fleet.workers[w]["completed"] for w in fleet.workers
              if w not in (1, 2)]
    assert fleet.workers[2]["quarantined"], "tamperer must end benched"
    assert fleet.workers[2]["completed"] == 0, "no tampered strip accepted"
    assert fleet.workers[1]["completed"] < max(honest), \
        "the straggler should complete fewer strips than a healthy server"
    print("\nOK: determinants recovered exactly; the straggler was never "
          "evicted (it just did less),")
    print("and the tamperer contributed nothing — benched by its first "
          "rejected probe.")


if __name__ == "__main__":
    main()
