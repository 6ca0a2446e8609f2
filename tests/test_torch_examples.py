"""The port's examples (examples/*_torch.py) on the CPU at small sizes,
each as its own process with `--device cpu`: exit 0 and its own check
line, as CI runs the reference's examples. The quickstart's determinant
is also held to the reference's `outsource_determinant` on the same
matrix by `Determinant.allclose` (f64: rtol 1e-8).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import outsource_determinant as r_outsource_determinant
from repro.core.decipher import Determinant

ROOT = Path(__file__).resolve().parents[1]

#: script: (arguments, a line its run must print)
EXAMPLES = {
    "quickstart_torch.py": (["--n", "48", "--batch", "4"],
                            "OK: determinant recovered exactly"),
    "gp_loglik_torch.py": (["--n", "48", "--steps", "2", "--gateway"],
                           "OK: gateway op-keyed buckets agree"),
    "edge_gateway_torch.py": (["--clients", "12"],
                              "tampered buckets healed without touching "
                              "clean ones. OK"),
    "rateless_fleet_torch.py": (["--n", "32", "--batch", "4"],
                                "OK: determinants recovered exactly"),
    "role_split_torch.py": (["--n", "32"], "det matches honest"),
    "secure_edge_cluster_torch.py": (["--servers", "4", "--n", "61"],
                                     "one-way relay traffic"),
    "serve_lm_torch.py": (["--arch", "gemma3-1b"], "[serve] sample token ids"),
}


def _run(script: str, args: list[str]) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args,
         "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_cpu(script):
    args, line = EXAMPLES[script]
    out = _run(script, args)
    assert line in out, out[-3000:]
    if script == "secure_edge_cluster_torch.py":
        assert out.count("(OK)") == 2, out


def test_quickstart_determinant_equals_reference():
    """The n = 48 client matrix of the quickstart (seed 0): the port's
    printed (sign, log|det|) against the reference's protocol run."""
    out = _run("quickstart_torch.py", ["--n", "48", "--batch", "0"])
    sign, logabs = re.search(r"det \(sign,logabs\) = \(([+-]\d+), ([-\d.]+)\)",
                             out).groups()
    rng = np.random.default_rng(0)
    m = rng.standard_normal((48, 48)) + 48 * np.eye(48)
    want = r_outsource_determinant(m, 4).det
    assert want.allclose(Determinant(sign=float(sign), logabs=float(logabs)))
