#!/usr/bin/env python3
"""Q3 verdicts on honest runs under element growth, over the overload
property test's whole input space, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python q3_growth_scan.py [--seeds 0:10001] [--workers 4]

tests/test_torch_overload.py::test_random_interleavings_match_sequential_oracle
draws seed in [0, 10000] and serves up to 10 requests: request i is
`randn(n, n) + n·I` from numpy's default_rng(100·seed + i), n in [2, 16]
drawn from default_rng(seed), in a gateway with buckets (8, 16) over
N = 2 servers. For every such matrix this script opens the port's
session at its bucket, factors the ciphertext with `lu_nserver` and
prints a JSON line wherever Q3 rejects the honest run, by the port's
compensated (exact) sum or by the working-precision sum the port used
before: both residuals, ε and the growth. With --reference it adds, for
those matrices, the JAX reference's own Q3 and the exact residual of the
reference's factors, and first a line for request 9 of seed 1695 on
the direct path (`outsource_determinant(m, 2)`, the property test's
oracle) in both packages. A last line counts the matrices and
rejections.
About four minutes with four workers (the reference adds a few seconds
a flagged matrix).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os

os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np  # noqa: E402

N_SERVERS = 2
BUCKETS = (8, 16)


def matrices(seed: int):
    """(request, n, bucket, matrix) of one seed's 10 requests."""
    rng = np.random.default_rng(seed)
    for i in range(10):
        n = int(rng.integers(2, 17))
        m = np.random.default_rng(seed * 100 + i).standard_normal((n, n))
        yield i, n, next(b for b in BUCKETS if b >= n), m + n * np.eye(n)


def working_precision_q3(l, u, x):
    import torch

    diag = torch.einsum("...ij,...ji->...i", torch.tril(l), torch.triu(u))
    return torch.abs(diag - torch.diagonal(x, dim1=-2, dim2=-1)).sum(dim=-1)


def scan(seeds: range) -> tuple[int, list[dict]]:
    import torch

    torch.set_num_threads(1)
    from repro_torch.api import SPDCClient
    from repro_torch.core import verify
    from repro_torch.core.lu import lu_nserver

    client = SPDCClient(device="cpu")
    count, flagged = 0, []
    for seed in seeds:
        for i, n, bucket, m in matrices(seed):
            x = client.open_session([m], N_SERVERS, pad_to=bucket).x_aug
            l, u, _ = lu_nserver(x, N_SERVERS)
            growth = verify.growth_estimate(u, x)
            eps = verify.epsilon(N_SERVERS, bucket, x) * np.minimum(
                growth, verify.q3_growth_cap(bucket))
            exact = verify.q3(l, u, x).numpy()
            plain = working_precision_q3(l, u, x).numpy()
            count += 1
            if (exact > eps).any() or (plain > eps).any():
                flagged.append({"seed": seed, "request": i, "n": n,
                                "bucket": bucket, "eps": float(eps[0]),
                                "growth": float(growth[0]),
                                "exact_q3": float(exact[0]),
                                "working_precision_q3": float(plain[0])})
    return count, flagged


def reference_reading(row: dict) -> dict:
    """The reference's Q3 on its own factors of the same request, and the
    exact residual of those factors (the port's compensated sum)."""
    import torch

    import repro.linalg  # noqa: F401 — before the first jax dispatch
    import repro.api as r_api
    from repro.core import lu as r_lu
    from repro.core import verify as r_verify
    from repro_torch.core import verify

    m = dict((i, mm) for i, _, _, mm in matrices(row["seed"]))[row["request"]]
    x = r_api.SPDCClient().open_session([m], N_SERVERS,
                                        pad_to=row["bucket"]).x_aug
    l, u, _ = r_lu.lu_nserver(x, N_SERVERS)
    eps = r_verify.epsilon(N_SERVERS, row["bucket"], x) * np.minimum(
        r_verify.growth_estimate(u, x), r_verify.q3_growth_cap(row["bucket"]))
    exact = verify.q3(*(torch.from_numpy(np.array(a)) for a in (l, u, x)))
    return {"reference_q3": float(np.asarray(r_verify.q3(l, u, x))[0]),
            "reference_eps": float(np.asarray(eps)[0]),
            "reference_factors_exact_q3": float(exact[0])}


def direct_reading(seed: int, request: int) -> dict:
    """One request on the direct path, `outsource_determinant(m, 2)` (n
    padded to the next even size, not to a bucket): both packages'
    verdicts, the port's Q3 in both sums and the exact residuals of both
    packages' factors."""
    import torch

    import repro.linalg  # noqa: F401 — before the first jax dispatch
    import repro.api as r_api
    from repro.core import lu as r_lu
    from repro.core import protocol as r_protocol
    from repro_torch.api import SPDCClient
    from repro_torch.core import protocol, verify
    from repro_torch.core.lu import lu_nserver

    m = dict((i, mm) for i, _, _, mm in matrices(seed))[request]
    port = protocol.outsource_determinant(m, N_SERVERS, device="cpu")
    ref = r_protocol.outsource_determinant(m, N_SERVERS)
    x = SPDCClient(device="cpu").open_session(m, N_SERVERS).x_aug
    l, u, _ = lu_nserver(x, N_SERVERS)
    xr = r_api.SPDCClient().open_session(m, N_SERVERS).x_aug
    lr, ur, _ = r_lu.lu_nserver(xr, N_SERVERS)
    exact_r = verify.q3(*(torch.from_numpy(np.array(a)) for a in (lr, ur, xr)))
    return {"direct": {"seed": seed, "request": request, "n": m.shape[0],
                       "port_verified": bool(port.verified),
                       "port_exact_q3": port.residual,
                       "port_working_precision_q3": float(
                           working_precision_q3(l, u, x)),
                       "port_eps": port.report.verdict.eps,
                       "reference_verified": bool(ref.verified),
                       "reference_q3": float(ref.residual),
                       "reference_factors_exact_q3": float(exact_r)}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0:10001",
                        help="a range of seeds, start:stop")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--reference", action="store_true")
    args = parser.parse_args()
    start, stop = map(int, args.seeds.split(":"))
    bounds = np.linspace(start, stop, args.workers + 1).astype(int)
    parts = [range(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        results = pool.map(scan, parts)
    count = sum(c for c, _ in results)
    flagged = [row for _, rows in results for row in rows]
    if args.reference:
        print(json.dumps(direct_reading(1695, 9)), flush=True)
    for row in flagged:
        if args.reference:
            row.update(reference_reading(row))
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "matrices": count,
        "rejected_by_exact_q3": sum(r["exact_q3"] > r["eps"] for r in flagged),
        "rejected_by_working_precision_q3": sum(
            r["working_precision_q3"] > r["eps"] for r in flagged)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
