"""Serving example on the PyTorch port: batched greedy generation with
per-layer-kind caches (ring-buffered sliding windows for gemma3, SSM state
for mamba2), on the CUDA device.

    python examples/serve_lm_torch.py --arch gemma3-1b
    python examples/serve_lm_torch.py --arch mamba2-370m --device cpu

A thin veneer over the port's launcher (`python -m repro_torch.launch.serve`),
the twin of examples/serve_lm.py: the same smoke run (4 × 12 prompts, 20
new tokens), any further flag going to the launcher (--device cpu for the
plain path).
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    args = sys.argv[1:] or ["--arch", "tinyllama-1.1b"]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--batch", "4", "--prompt-len", "12", "--gen", "20"] + args
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    print("+", " ".join(cmd))
    sys.exit(subprocess.call(cmd, env=env, cwd=ROOT))


if __name__ == "__main__":
    main()
