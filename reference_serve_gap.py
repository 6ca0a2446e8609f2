#!/usr/bin/env python3
"""The JAX reference's own gap between decode and prefill in bf16, and the
port's on the same weights, at a model's full width, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python reference_serve_gap.py [--arch mamba2-370m] [--seed 0]

Draws the reference's weights (`init_lm` on the full config, bf16) from
--seed, and 4 prompts of 128 tokens from numpy's default_rng(seed); runs
the reference's prefill step and its decode step over the 128 tokens,
then the port's (weights carried by `repro_torch.interop`) on the CPU.
Prints one JSON line: max |decode − prefill| of the last logits over
max |prefill| for each package, and the two packages' prefill and decode
logits against each other, on the real vocabulary. chip_smoke.py's
per-arch bf16 bound (SERVE_TOL_BF16) rests on these readings. About
three minutes for mamba2-370m.
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np  # noqa: E402

BATCH, LENGTH = 4, 128


def rel(got: np.ndarray, want: np.ndarray, vocab: int) -> float:
    got, want = got[:, :vocab], want[:, :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="mamba2-370m")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as r_configs
    from repro.models.common import split_tree
    from repro.models.lm import init_lm
    from repro.serve import kvcache as r_kvcache
    from repro.serve import steps as r_steps
    from repro_torch import configs, interop
    from repro_torch.serve import kvcache, steps

    t0 = time.perf_counter()
    cfg_r, cfg = r_configs.get_config(args.arch), configs.get_config(args.arch)
    params, _ = split_tree(init_lm(cfg_r, jax.random.key(args.seed)))
    tokens = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (BATCH, LENGTH)).astype(np.int32)

    prefill_r = np.asarray(jax.jit(r_steps.build_prefill_step(cfg_r))(
        params, {"tokens": jnp.asarray(tokens)}), np.float32)
    decode_r = jax.jit(r_steps.build_decode_step(cfg_r))
    caches_r = r_kvcache.init_caches(cfg_r, BATCH, LENGTH)
    for t in range(LENGTH):
        logits_r, caches_r = decode_r(params, caches_r,
                                      {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                                      jnp.full((BATCH,), t, jnp.int32))
    logits_r = np.asarray(logits_r, np.float32)

    model = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                         device="cpu")
    prefill = steps.build_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(tokens)}).float().numpy()
    decode = steps.build_decode_step(cfg)
    caches = kvcache.init_caches(cfg, BATCH, LENGTH, device="cpu")
    for t in range(LENGTH):
        logits, caches = decode(model, caches,
                                {"tokens": torch.from_numpy(tokens[:, t:t + 1])},
                                torch.full((BATCH,), t, dtype=torch.int32))
    logits = logits.float().numpy()

    v = cfg.vocab_size
    print(json.dumps({
        "arch": args.arch, "dtype": cfg.activation_dtype, "seed": args.seed,
        "batch": BATCH, "tokens": LENGTH,
        "reference_decode_vs_prefill": rel(logits_r, prefill_r, v),
        "port_decode_vs_prefill": rel(logits, prefill, v),
        "port_vs_reference_prefill": rel(prefill, prefill_r, v),
        "port_vs_reference_decode": rel(logits, logits_r, v),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
