#!/usr/bin/env python3
"""The JAX reference's verdict on chip_smoke.py's default-magnitude
in-band tamper, at the smoke's own size, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python reference_fault_witness.py [--seed 0] [--n 4096]

Draws the matrix of the faults phase's witness case (witness_matrix:
standard_normal from numpy's default_rng(seed) rounded to multiples of
2^-16, plus n·I), opens a reference session over N = 4
servers, and runs the inline sweep under q3 and under q1, each honest and
with ServerFault(server=2, mode="single", in_band=True) at its default
magnitude. Prints one JSON line per run: verdict, culprit, residual, ε(N),
SeedGen's digest and the sha256 of the ciphertext x_aug, which
chip_smoke.py prints beside the port's verdict on the same matrix.

It imports the reference only; chip_smoke.py holds the port to the verdict
and culprit this script prints (WITNESS_REFERENCE there).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os

os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np  # noqa: E402

N_SERVERS = 4


def witness_matrix(seed: int, n: int) -> np.ndarray:
    """standard_normal rounded to multiples of 2^-16, plus n·I. Every
    partial sum of its entries is exact in float64, so SeedGen's mean, and
    with it the keys and the ciphertext, are the same on every machine;
    numpy's pairwise sum of unrounded entries differs in its last bits
    between CPUs and numpy versions."""
    z = np.random.default_rng(seed).standard_normal((n, n))
    return np.round(z * 2.0**16) / 2.0**16 + n * np.eye(n)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n", type=int, default=4096)
    args = parser.parse_args()

    from repro.api import SPDCClient
    from repro.core.faults import ServerFault

    n = args.n
    m = witness_matrix(args.seed, n)
    plans = {"honest": None,
             "in_band_single_server2": ServerFault(server=2, mode="single",
                                                   in_band=True)}
    for method in ("q3", "q1"):
        for label, plan in plans.items():
            run(SPDCClient(method=method), m, plan, label, args.seed)


def run(client, m, plan, label, seed) -> None:
    """One inline sweep of a fresh session; prints its JSON line."""
    session = client.open_session(m, N_SERVERS, faults=plan)
    x_aug = np.ascontiguousarray(np.asarray(session.x_aug))
    res = session.run()
    verdict = res.report.verdict
    print(json.dumps({
        "run": label, "n": m.shape[-1], "seed": seed, "method": verdict.method,
        "magnitude": None if plan is None else plan.magnitude,
        "verified": bool(res.verified), "culprit": int(verdict.culprit),
        "residual": float(verdict.residual), "eps": float(verdict.eps),
        "seed_digest": session.digest.hex(),
        "x_aug_sha256": hashlib.sha256(x_aug.tobytes()).hexdigest(),
    }), flush=True)


if __name__ == "__main__":
    main()
