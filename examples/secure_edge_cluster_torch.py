"""Secure edge cluster on the PyTorch port: the distributed SPDC pipeline
(`distributed=True`, the shardmap transport: one server slot per block
row, each computing on a CUDA stream of its own, the one-way relay a
device copy a hop), including the paper's odd-size augmentation and a
comparison of EWD vs EWM recovery.

    python examples/secure_edge_cluster_torch.py [--servers 8] [--n 237]
    python examples/secure_edge_cluster_torch.py --servers 4 --device cpu

The twin of examples/secure_edge_cluster.py, which forces 8 XLA host
devices; here the N slots share the devices torch sees (slot i on CUDA
device i % count; on the CPU, slots in turn). The same flags and printed
checks, plus --device (default: the CUDA device).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import outsource_determinant
from repro_torch.distrib.spdc_pipeline import pipeline_collective_bytes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--servers", type=int, default=8)
    ap.add_argument("--n", type=int, default=237)  # deliberately awkward size
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    rng = np.random.default_rng(1)
    m = rng.standard_normal((args.n, args.n)) + args.n * np.eye(args.n)
    want_sign, want_log = np.linalg.slogdet(m)

    print(f"cluster: {args.servers} edge servers (one server slot each)")
    print(f"matrix:  {args.n}x{args.n} (odd/awkward on purpose)")

    padding = 0
    for mode in ("ewd", "ewm"):
        res = outsource_determinant(
            m, args.servers, mode=mode, distributed=True, method="q2",
            device=args.device,
        )
        padding = res.padding
        ok = (res.verified and res.det.sign == want_sign
              and np.isclose(res.det.logabs, want_log, rtol=1e-9))
        status = "OK" if ok else "MISMATCH"
        print(f"  CED={mode}: padded +{res.padding} -> "
              f"{(args.n + res.padding)}, verified={res.verified}, "
              f"logdet={res.det.logabs:.6f} ({status})")
        assert ok, f"CED={mode}: {status}"

    info = pipeline_collective_bytes(args.n + padding, args.servers)
    print(f"one-way relay traffic: {info['relay_bytes']/1e6:.1f} MB "
          f"(paper-exact {info['paper_exact_bytes']/1e6:.1f} MB, "
          f"fixed-shape overcount {info['overcount_factor']:.2f}x)")
    print("note: no all-gather/all-reduce in the pipeline — one relay copy "
          "a hop to the next slot (tests/test_torch_pipeline.py holds the "
          "copies to the mesh's hop log).")


if __name__ == "__main__":
    main()
