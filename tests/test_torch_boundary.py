"""The port's boundaries: it imports neither jax nor the reference
package, its entry points do not fall back to the CPU, its trust
boundary passes the reference's own secret-taint lint, and the gateway's
guarded state passes its lock-discipline lint.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import interop
from tools.repro_lint import lint_sources

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py"
)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py"))
    + [REPO / name for name in ("chip_smoke.py", "profile_clock_probe.py",
                                "profile_parse_probe.py", "prefill_ab.py",
                                "schur_ab.py", "flash_ab.py", "decode_trace.py",
                                "train_ab.py")]
    + sorted((REPO / "examples").glob("*_torch.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_reference_import_in_source(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_points_refuse_cpu_fallback():
    """Without device=, the entry points run on CUDA or raise."""
    m = np.eye(8) * 2.0
    if torch.cuda.is_available():
        assert repro_torch.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.outsource_determinant(m, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SPDCClient()
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.factors_from_numpy(m, m)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.outsource_determinant_mixed([m, m[:6, :6]], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SPDCGateway()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.AsyncSPDCGateway()
    from repro_torch.launch import serve_spdc

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_spdc.main(["--smoke"])


def test_cpu_on_request():
    m = np.random.default_rng(0).standard_normal((8, 8)) + 8 * np.eye(8)
    res = repro_torch.outsource_determinant(m, 2, device="cpu")
    sign, logabs = np.linalg.slogdet(m)
    assert res.verified and res.det.sign == sign
    assert abs(res.det.logabs - logabs) < 1e-12


def _port_sources_as_reference_paths():
    """The port's core/, api/, linalg/, distrib/, serve/ and configs/
    sources keyed under their reference paths, so the taint and lock
    passes' src/repro/ scopes (and the lock pass's required guards)
    apply to them."""
    sources = {}
    for sub in ("core", "api", "linalg", "distrib", "serve", "configs"):
        for p in sorted((PORT / sub).glob("*.py")):
            sources[f"src/repro/{sub}/{p.name}"] = p.read_text(encoding="utf-8")
    return sources


@pytest.mark.parametrize("lint_pass", ["taint", "locks"])
def test_port_trust_boundary_passes_taint_lint(lint_pass):
    sources = _port_sources_as_reference_paths()
    for path in ("api/client.py", "linalg/session.py", "linalg/ops.py",
                 "distrib/recovery.py", "serve/spdc_gateway.py",
                 "serve/queue.py", "configs/spdc.py"):
        assert f"src/repro/{path}" in sources
    findings = lint_sources(sources, passes=[lint_pass], root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_lock_lint_sees_the_port_gateway():
    """The lock pass has teeth on the port: the guarded-by annotation
    taken off the gateway's queue trips SPDC206 (a required guard)."""
    sources = _port_sources_as_reference_paths()
    path = "src/repro/serve/spdc_gateway.py"
    anchor = ("        #: guarded-by: self._lock\n"
              "        self._queue = MicroBatchQueue(")
    assert anchor in sources[path]
    sources[path] = sources[path].replace(
        anchor, "        self._queue = MicroBatchQueue(", 1)
    codes = [f.code for f in lint_sources(sources, passes=["locks"],
                                          root=REPO)]
    assert codes == ["SPDC206"]


def _planted_codes(path, anchor, planted):
    """The taint pass's codes on the port's sources with `planted`
    inserted after `anchor` in `path`."""
    sources = _port_sources_as_reference_paths()
    assert anchor in sources[path]
    sources[path] = sources[path].replace(anchor, anchor + planted, 1)
    return [f.code for f in lint_sources(sources, passes=["taint"], root=REPO)]


def test_taint_lint_sees_the_port():
    """The check has teeth: a plaintext print planted in the port's
    client is flagged."""
    codes = _planted_codes("src/repro/api/client.py",
                           "        seed = seedgen(self.lambda1, m_host)\n",
                           "        print(seed)\n")
    assert "SPDC102" in codes


def test_taint_lint_sees_the_port_linalg():
    """And in its linalg session: the plaintext matrix printed."""
    codes = _planted_codes("src/repro/linalg/session.py",
                           "        m = np.asarray(m)\n", "        print(m)\n")
    assert "SPDC102" in codes
