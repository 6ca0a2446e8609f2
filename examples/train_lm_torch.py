"""End-to-end training on the PyTorch port: train the ~100M-param
repro-100m model on synthetic Markov data, with checkpoints, resume and
the Freivalds SDC check, on the CUDA device.

    python examples/train_lm_torch.py                    # full run (300 steps)
    python examples/train_lm_torch.py --quick            # a short run (30 steps)
    python examples/train_lm_torch.py --quick --device cpu

A thin veneer over the port's launcher (`python -m repro_torch.launch.train`),
the same code path; the twin of examples/train_lm.py. Any further flag
goes to the launcher. Checkpoints go to a fresh temporary directory,
removed afterwards, unless --ckpt names one.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    quick = "--quick" in sys.argv
    extra = [a for a in sys.argv[1:] if a != "--quick"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="repro_torch_100m_") as ckpt:
        cmd = [
            sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "repro-100m",
            "--steps", "30" if quick else "300",
            "--batch", "4" if quick else "16",
            "--seq", "128" if quick else "512",
            "--sdc",
        ] + ([] if "--ckpt" in extra else ["--ckpt", ckpt]) + extra
        print("+", " ".join(cmd))
        return subprocess.call(cmd, env=env, cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
