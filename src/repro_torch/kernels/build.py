"""Build the port's CUDA kernels at first use.

Each `csrc/<name>.cu` compiles with its own `nvcc`, all started together,
into a shared library with a plain C interface that the wrappers bind
with ctypes. No source includes PyTorch's headers, so a build takes
seconds rather than minutes. Libraries are named by a hash of their
source and flags, so an edited source rebuilds and an unchanged one is
reused; they live in `_build/` beside this file (ignored by git).

The first use is safe when threads race to it (the gateway's sweeps
run on worker threads): one lock serializes building and loading, so
no two nvcc runs write one library and every thread gets the one
loaded copy.

Flags: `-O3` for `sm_90a`, and no `--use_fast_math` — it would turn the
CED kernel's float division into an approximate one, and that kernel
must agree bit for bit with its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("ced", "lu_panel", "trsm", "schur", "flash_attn")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: seconds one nvcc may take before the build is abandoned
NVCC_TIMEOUT_S = 600

#: loaded libraries: written under _BUILD_LOCK, read without it (a
#: dict lookup is atomic, and a miss takes the lock and looks again)
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.RLock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME, else the toolkit's
    default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def target(name: str) -> Path:
    """The library path for csrc/<name>.cu at its current content and
    that of the headers beside it."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one nvcc
    each, all at once. Returns {name: seconds} for what it compiled,
    each from the start to that nvcc's own exit; raises with the
    compiler's output if any compile fails. The ptxas report (registers,
    shared memory, spills) is kept beside each library as
    `<library>.log`."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names) -> dict[str, float]:
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    try:
        for name in names:
            out = target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = Path(f"{out}.log")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            # the compiler's output goes to its log file, not a pipe that
            # could fill while the others are waited for
            with log.open("w") as sink:
                proc = subprocess.Popen(cmd, stdout=sink,
                                        stderr=subprocess.STDOUT)
            started[name] = (proc, tmp, out, log, time.perf_counter())
        seconds, failed = {}, []
        deadline = time.perf_counter() + NVCC_TIMEOUT_S
        while len(seconds) < len(started):
            for name, (proc, tmp, out, log, t0) in started.items():
                if name in seconds or proc.poll() is None:
                    continue
                seconds[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                                  f"{log.read_text()}")
                else:
                    os.replace(tmp, out)
            if len(seconds) < len(started):
                if time.perf_counter() > deadline:
                    late = sorted(set(started) - set(seconds))
                    raise RuntimeError(f"nvcc took over {NVCC_TIMEOUT_S} s "
                                       f"for {', '.join(late)}")
                time.sleep(0.05)
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use, with
    each function's ctypes signature declared: signatures maps a symbol
    to (restype, argtypes)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(target(name)))
            for symbol, (restype, argtypes) in signatures.items():
                fn = getattr(lib, symbol)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            lib.spdc_error_string.restype = ctypes.c_char_p
            lib.spdc_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise if a launcher reported a CUDA error (its cudaGetLastError()
    right after the launch): a refused launch never runs, and a later
    synchronize would not report it."""
    if code != 0:
        what = lib.spdc_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({what})")
