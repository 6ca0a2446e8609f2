"""Quickstart on the PyTorch port: securely outsource one determinant
through the full SPDC protocol — SeedGen → KeyGen → Cipher(CED) →
Parallelize(N-server LU) → Authenticate(Q3) → Decipher — then a batched
stack through the same API, on the CUDA device.

    python examples/quickstart_torch.py [--n 256] [--servers 4] [--batch 8]
    python examples/quickstart_torch.py --n 48 --batch 4 --device cpu

The twin of examples/quickstart.py: the same flags and the same printed
checks, plus --device (default: the CUDA device; "cpu" runs each
kernel's plain PyTorch version).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import ServerFault, outsource_determinant


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--mode", choices=["ewd", "ewm"], default="ewd")
    ap.add_argument("--method", choices=["q1", "q2", "q3"], default="q3")
    ap.add_argument("--batch", type=int, default=8,
                    help="size of the batched demo stack (0 to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    dev = args.device

    rng = np.random.default_rng(0)
    # a client matrix (well-conditioned, as an outsourcing client can ensure)
    m = rng.standard_normal((args.n, args.n)) + args.n * np.eye(args.n)

    print(f"Outsourcing det of a {args.n}x{args.n} matrix to "
          f"{args.servers} untrusted edge servers (CED: {args.mode} + PRT, "
          f"verify: {args.method})")
    res = outsource_determinant(
        m, args.servers, mode=args.mode, method=args.method, device=dev
    )
    want_sign, want_log = np.linalg.slogdet(m)

    print(f"  seed Ψ            = {res.seed.psi:.6f}")
    print(f"  rotation          = {res.meta.rotate_k * 90}°")
    print(f"  padding           = {res.padding}")
    print(f"  verified          = {res.verified} (residual {res.residual:.2e})")
    print(f"  det (sign,logabs) = ({res.det.sign:+.0f}, {res.det.logabs:.10f})")
    print(f"  numpy slogdet     = ({want_sign:+.0f}, {want_log:.10f})")
    assert res.verified
    assert res.det.sign == want_sign
    assert np.isclose(res.det.logabs, want_log, rtol=1e-9)
    print("OK: determinant recovered exactly; servers saw only the ciphertext.")

    # a malicious server corrupts its block — the client catches it
    def tamper(l, u):
        l = l.clone()
        l[5, 2] += 0.05
        return l, u

    bad = outsource_determinant(m, args.servers, tamper=tamper, device=dev)
    print(f"  tampered result rejected = {not bad.verified} "
          f"(residual {bad.residual:.2e})")
    assert not bad.verified

    # fault tolerance (DESIGN.md §4): name the tampering server via the
    # per-server residuals, re-dispatch ONLY its shard to a standby, and
    # recover the exact determinant — no full re-outsource
    culprit_server = min(1, args.servers - 1)
    healed = outsource_determinant(
        m, args.servers, mode=args.mode, method=args.method,
        faults=ServerFault(server=culprit_server, kind="tamper"),
        recover=True, standby=1, device=dev,
    )
    rep = healed.report.recovery
    print(f"  tampered server {culprit_server}: localized culprit="
          f"{rep.events[0].server}, shard re-dispatched to standby "
          f"server {rep.events[0].replacement} "
          f"({rep.rounds} round(s), {rep.events[0].comm_elements} elements "
          f"on the wire vs {(args.n + healed.padding)**2} for re-outsource)")
    assert healed.verified and rep.ok
    assert healed.det.sign == want_sign
    assert np.isclose(healed.det.logabs, want_log, rtol=1e-9)
    print("  recovered determinant matches — one extra hop, not a restart.")

    # a straggler past the client's deadline is re-dispatched the same way
    slow = outsource_determinant(
        m, args.servers,
        faults=ServerFault(server=args.servers - 1, kind="delay",
                           delay_rounds=9),
        straggler_deadline=4, recover=True, standby=1, device=dev,
    )
    assert slow.verified and slow.report.recovery.ok
    print(f"  straggler (9 rounds late, deadline 4): shard re-dispatched, "
          f"verified={slow.verified}")

    # role-split transports (DESIGN.md §7): the same protocol with the
    # client and the untrusted workers as separate objects — here on a
    # thread pool (see examples/role_split_torch.py for the role API)
    role = outsource_determinant(m, args.servers, transport="threadpool",
                                 device=dev)
    assert role.verified and role.det.sign == want_sign
    assert np.isclose(role.det.logabs, want_log, rtol=1e-9)
    print("  role-split threadpool transport: verified, same determinant")

    if args.batch:
        # batch-first: a (B, n, n) stack goes through the identical protocol
        # in ONE call — per-matrix seeds/keys/rotations/verdicts, one sweep
        # of the N-server schedule (DESIGN.md §3)
        stack = rng.standard_normal((args.batch, args.n, args.n)) \
            + args.n * np.eye(args.n)
        t0 = time.perf_counter()
        batch_res = outsource_determinant(
            stack, args.servers, mode=args.mode, method=args.method,
            device=dev
        )
        dt = time.perf_counter() - t0
        assert np.asarray(batch_res.verified).all()
        for i in range(args.batch):
            ws, wl = np.linalg.slogdet(stack[i])
            assert batch_res.dets[i].sign == ws
            assert np.isclose(batch_res.dets[i].logabs, wl, rtol=1e-8)
        print(f"  batched: {args.batch} matrices outsourced+verified in one "
              f"call ({dt:.3f}s, {args.batch / dt:.1f} dets/sec, "
              f"all verified)")

        # mixed sizes? a list coalesces into ONE padded sweep (the gateway
        # path — see examples/edge_gateway_torch.py)
        mixed = [rng.standard_normal((k, k)) + k * np.eye(k)
                 for k in (args.n // 2, args.n // 3, args.n)]
        mres = outsource_determinant(mixed, args.servers, device=dev)
        assert np.asarray(mres.verified).all()
        print(f"  mixed sizes {[x.shape[0] for x in mixed]} coalesced at "
              f"n'={mres.pad_to}: all verified")


if __name__ == "__main__":
    main()
