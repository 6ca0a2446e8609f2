"""Checkpointing: atomic, verified, async, restorable onto any device.

Port of src/repro/train/checkpoint.py, with its layout (one directory a
step):

    ckpt_dir/step_000000042.tmp-<pid>/  — written here first
        manifest.json                   — path, file, shape, dtype, hash a leaf
        leaf_000000.npy …               — one file a leaf (params + opt state)
    ckpt_dir/step_000000042/            — os.rename on completion

  * atomicity — a crash mid-write never corrupts the latest checkpoint
                (tmp dir + rename; restore reads complete dirs only)
  * integrity — each leaf's SHA-256 (first 16 hex digits) in the
                manifest, checked on restore: a corrupted leaf raises
                IOError (the loop then falls back to the step before)
  * async     — save copies the leaves to the host, then a writer thread
                writes them; `wait()` joins it before the next save
  * placement — restore(template, step, device=) puts every leaf on any
                device in its template's dtype (the reference's
                `restore_sharded` places onto any mesh)
  * gc        — the newest `keep_last` steps are kept

A sharded leaf (a DTensor) is gathered whole before it is written, so a
sharded run and an unsharded one write the same files; only rank 0 of a
process group writes them, and a restore places each leaf back as its
template leaf is placed.

A tree is nested dicts whose leaves are tensors (or arrays), or a model
(`models.lm.LM`), whose leaves are its named parameters. A leaf's path
joins the dict keys (sorted, as the reference's tree flattening orders
them) with "/" and then the parameter's name: "params/stack.0.mixer.wq",
"opt/mu/lm_head", "opt/step".

numpy has no bfloat16 (the reference's comes from ml_dtypes, which the
port does not need): a bf16 leaf is stored as its 16-bit patterns
(uint16) with "bfloat16" in the manifest, so its file holds, and its hash
covers, the bytes the reference writes for the same values (ROADMAP §C).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..distrib.sharding import full, is_sharded

BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, nn.Module):
        return [(prefix + name, p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in _flatten(tree[key], f"{prefix}{key}/")]
    return [(prefix.rstrip("/"), tree)]


def _unflatten(template, leaves: dict, prefix: str = ""):
    if isinstance(template, nn.Module):
        from ..models.lm import LM, with_parameters

        if not isinstance(template, LM):
            raise TypeError(f"cannot rebuild a {type(template).__name__}")
        return with_parameters(template, {
            name: leaves[prefix + name] for name, _ in template.named_parameters()})
    if isinstance(template, dict):
        return {key: _unflatten(template[key], leaves, f"{prefix}{key}/")
                for key in template}
    return leaves[prefix.rstrip("/")]


def _writes() -> bool:
    """Whether this process writes checkpoint files: rank 0 of a process
    group, or any process outside one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = full(leaf.detach()).cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        #: seconds each completed write took (files, hashes, rename, gc)
        self.write_seconds: list[float] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        host = [(path, *_to_host(leaf)) for path, leaf in _flatten(tree)]
        if not _writes():
            return
        self.wait()
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def _write(self, step: int, host: list) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:06d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype, "sha": _sha(arr)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.write_seconds.append(time.perf_counter() - t0)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in self.dir.iterdir():
            if (d.is_dir() and d.name.startswith("step_")
                    and "tmp" not in d.name
                    and (d / "manifest.json").exists()):
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, *, device=None,
                verify: bool = True):
        """(a tree shaped as `template`, the step). Each leaf takes its
        template leaf's dtype, and lands on `device` where given, else on
        its template leaf's device (the CPU for an array)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {m["path"]: m for m in manifest["leaves"]}
        leaves = {}
        for path, like in _flatten(template):
            m = by_path[path]
            arr = np.load(d / m["file"])
            if verify and _sha(arr) != m["sha"]:
                raise IOError(f"checkpoint corruption detected in {path}")
            if m["dtype"] == BF16:
                value = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                value = torch.from_numpy(arr)
            like = torch.as_tensor(like)
            if tuple(value.shape) != tuple(like.shape):
                raise ValueError(f"{path}: stored {tuple(value.shape)}, "
                                 f"template {tuple(like.shape)}")
            value = value.to(device=device or like.device, dtype=like.dtype)
            if is_sharded(like):
                from torch.distributed.tensor import distribute_tensor

                value = distribute_tensor(value, like.device_mesh,
                                          like.placements)
            leaves[path] = value
        return _unflatten(template, leaves), step
