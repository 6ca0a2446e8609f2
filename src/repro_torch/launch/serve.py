"""LM-serving launcher: batched greedy generation against the decode
cache.

    python -m repro_torch.launch.serve --full            # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Port of src/repro/launch/serve.py, with the same flags plus --device.
Without --device it runs on the CUDA device, or raises where there is
none. Weights come from --seed; nothing is downloaded.

NOTE: this serves the model zoo's language models, not the paper's
workload (the SPDC determinant).
"""
from __future__ import annotations

import argparse
import sys
import time

from ..configs import get_config, smoke_config
from ..device import resolve_device, synchronize
from ..models.lm import init_lm
from ..serve.steps import greedy_generate
from ..train.data import SyntheticLM


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.causal:
        print(f"{cfg.name} is encoder-only: no decode step (DESIGN.md §4)")
        return 0
    params = init_lm(cfg, args.seed, device=device)
    data = SyntheticLM(cfg, seed=args.seed)
    prompt = data.batch(0, args.batch, args.prompt_len)["tokens"].to(device)

    synchronize(device)
    t0 = time.time()
    out = greedy_generate(cfg, params, prompt, steps=args.gen)
    synchronize(device)
    dt = time.time() - t0
    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"generated={args.gen} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve] sample token ids:", out[0, :24].tolist())
    assert out.shape == (args.batch, args.prompt_len + args.gen)
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())
    return 0


if __name__ == "__main__":
    sys.exit(main())
