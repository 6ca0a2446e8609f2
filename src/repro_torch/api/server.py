"""EdgeServer — the untrusted worker role of the SPDC protocol (port of
repro.api.server).

A stateless executor of ShardTasks: given its encrypted block row and the
U rows relayed from upstream, it computes the (L strip, U strip) of paper
Algorithm 3's block row `task.server` and reports them back. It holds no
session state between tasks and sees only ciphertext (the trust boundary,
DESIGN.md §7). Its arithmetic is `core.lu.lu_block_row` in the task's
declared operation order, on the server's device, so an honest
EdgeServer's "nserver" strips are bit-equal to the strips the fused sweep
(`lu_nserver`) produces on the same device.

Misbehaviour is opt-in: `run(task, faults=plan)` applies the core.faults
model to the strips this server reports, before the relay forwards them
(the paper's in-band threat). Faults bind to the initial assignment
(attempt 0); re-dispatches run honestly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.faults import corrupt_strip, normalize_plan, sample_delay
from ..core.lu import lu_block_row
from ..device import resolve_device
from .messages import ShardResult, TriSolveTask

__all__ = ["EdgeServer"]

_TORCH_DTYPES = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float16): torch.float16}


def _to_device(arr, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` (copied: wire-decoded arrays
    are read-only views of the frame)."""
    arr = np.asarray(arr)
    if arr.dtype not in _TORCH_DTYPES:
        raise TypeError(f"no compute dtype for a {arr.dtype} payload")
    return torch.tensor(arr, dtype=dtype or _TORCH_DTYPES[arr.dtype],
                        device=device)


class EdgeServer:
    """One untrusted edge worker (see module docstring).

    worker_id identifies the physical worker (process/thread slot): it is
    labelling for logs and fault routing, not protocol state. device is
    where the strips are computed: None means the CUDA device and raises
    RuntimeError without one; "cpu" runs the plain path.
    """

    def __init__(self, worker_id: int | None = None, *, device=None):
        self.worker_id = worker_id
        self.device = resolve_device(device)

    def run(self, task, faults=()) -> ShardResult:
        """Execute one ShardTask → its ShardResult (strips as host numpy
        arrays in the task's dtype).

        The strips are embedded into zero-filled (…, n', n') frames
        because `lu_block_row` is written against full-matrix
        coordinates; it reads only block row `task.server` of x and the
        rows above it of u, so the zeros are never consumed.
        """
        if isinstance(task, TriSolveTask):
            raise NotImplementedError("TriSolveTask execution: ROADMAP A10")
        if task.style not in ("nserver", "pipeline"):
            raise ValueError(f"unknown task style {task.style!r}")
        n, b, s0 = task.n, task.block, task.server * task.block
        if b * task.num_servers != n:
            raise ValueError(
                f"task block {b}×{task.num_servers} servers does not tile "
                f"n'={n}"
            )
        x_row = _to_device(task.x_row, self.device)
        lead = x_row.shape[:-2]
        x = x_row.new_zeros((*lead, n, n))
        x[..., s0 : s0 + b, :] = x_row
        u = torch.zeros_like(x)
        if task.u_upstream is not None and task.u_upstream.shape[-2]:
            u_up = _to_device(task.u_upstream, self.device, x_row.dtype)
            u[..., : u_up.shape[-2], :] = u_up
        elif task.server != 0:
            raise ValueError(
                f"server {task.server} needs upstream U rows; the "
                "transport must thread the one-way relay"
            )
        self._straggle(task, faults)
        l_row, u_row = lu_block_row(x, u, task.server, task.num_servers,
                                    style=task.style)
        l_row, u_row = self._misbehave(task, l_row, u_row, faults)
        return ShardResult(
            server=task.server,
            l_row=l_row.cpu().numpy(),
            u_row=u_row.cpu().numpy(),
            subseed=task.subseed,
            attempt=task.attempt,
            session_id=task.session_id,
        )

    def _bound(self, task) -> int:
        """The id faults bind to: the physical worker when known, else the
        task's block row."""
        return self.worker_id if self.worker_id is not None else task.server

    def _straggle(self, task, faults) -> None:
        """Play this worker's wall-clock delay faults (``delay_s``) as a
        real sleep. Slowness belongs to the machine, so it fires on every
        attempt."""
        bound = self._bound(task)
        wait = sum(
            sample_delay(f, token=task.subseed)
            for f in normalize_plan(faults)
            if f.kind == "delay" and f.server == bound and f.delay_s > 0.0
        )
        if wait > 0.0:
            time.sleep(wait)

    def _misbehave(self, task, l_row, u_row, faults):
        """Apply the simulated fault model to this server's reported
        strips: only faults naming this worker fire, and only on the
        initial dispatch. Message transports forward the reported U row
        down the relay, so every tamper here is in-band."""
        plan = [
            f for f in normalize_plan(faults)
            if f.server == self._bound(task) and task.attempt == 0
            and f.kind != "delay"
        ]
        batched = l_row.ndim == 3
        for f in plan:
            targets = ("l", "u") if f.kind == "dropout" else tuple(f.target)

            def hit(orig, factor, f=f):
                bad = corrupt_strip(orig, f, n=task.n, factor=factor)
                if f.matrices is not None and batched:
                    idx = torch.as_tensor(f.matrices, dtype=torch.long)
                    out = orig.clone()
                    out[idx] = bad[idx]
                    return out
                return bad

            if "l" in targets:
                l_row = hit(l_row, "l")
            if "u" in targets:
                u_row = hit(u_row, "u")
        return l_row, u_row
