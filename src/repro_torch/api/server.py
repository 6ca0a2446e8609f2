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

A TriSolveTask (the secure linalg rounds, DESIGN.md §12) is answered by
four left solves through the shipped factors, each `kernels.ops.trsm_left`:
on the CUDA device the hand-written solver of csrc/trsm.cu, on the CPU its
plain version.

Misbehaviour is opt-in: `run(task, faults=plan)` applies the core.faults
model to the strips this server reports, before the relay forwards them
(the paper's in-band threat), or to the solution chunk it reports. Faults
bind to the initial assignment (attempt 0); re-dispatches run honestly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.faults import corrupt_strip, normalize_plan, sample_delay
from ..core.lu import lu_block_row
from ..device import resolve_device
from ..kernels import ops
from .messages import ShardResult, TriSolveResult, TriSolveTask

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

    def run(self, task, faults=()):
        """Execute one protocol task → its result message: ShardTask →
        ShardResult (strips as host numpy arrays in the task's dtype),
        TriSolveTask → TriSolveResult (one solved column chunk). The
        dispatch is by message type, so every transport that decodes
        frames with `wire.decode_message` serves both.

        The strips are embedded into zero-filled (…, n', n') frames
        because `lu_block_row` is written against full-matrix
        coordinates; it reads only block row `task.server` of x and the
        rows above it of u, so the zeros are never consumed.
        """
        if isinstance(task, TriSolveTask):
            return self._run_trisolve(task, faults)
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

    def _run_trisolve(self, task: TriSolveTask, faults=()) -> TriSolveResult:
        """One column chunk through the session's verified factors:
        X' y = rhs as L a = rhs, U y = a, or with task.transpose the
        adjoint X'ᵀ y = rhs as Uᵀ a = rhs, Lᵀ y = a. The L legs divide by
        L's stored diagonal, as the reference's server does."""
        l = _to_device(task.l, self.device)
        u = _to_device(task.u, self.device, l.dtype)
        rhs = _to_device(task.rhs, self.device, l.dtype)
        if l.ndim != 2 or l.shape != u.shape or rhs.shape[0] != l.shape[-1]:
            raise ValueError(
                f"trisolve shapes disagree: l {tuple(l.shape)}, u "
                f"{tuple(u.shape)}, rhs {tuple(rhs.shape)}"
            )
        self._straggle(task, faults)
        if task.transpose:
            a = ops.trsm_left(u, rhs, upper=True, transpose_t=True)
            y = ops.trsm_left(l, a, upper=False, transpose_t=True)
        else:
            a = ops.trsm_left(l, rhs, upper=False)
            y = ops.trsm_left(u, a, upper=True)
        y = self._misbehave_solve(task, y, faults)
        return TriSolveResult(
            server=task.server,
            y=y.cpu().numpy(),
            subseed=task.subseed,
            transpose=task.transpose,
            col0=task.col0,
            attempt=task.attempt,
            session_id=task.session_id,
        )

    def _misbehave_solve(self, task, y, faults):
        """The trisolve leg of the fault model: a tamper naming this
        worker corrupts the reported chunk (any target: the chunk is all
        this round reports), a dropout zeroes it; initial dispatch only.
        A single or sign-flip tamper hits the element the reference's
        hash picks inside the (n', c) chunk, so both packages corrupt
        the same one."""
        plan = [
            f for f in normalize_plan(faults)
            if f.server == self._bound(task) and task.attempt == 0
            and f.kind != "delay"
        ]
        for f in plan:
            if f.kind == "dropout":
                y = torch.zeros_like(y)
                continue
            if f.mode == "block":
                y = y * (1.0 + f.magnitude)
                continue
            h = (f.seed * 1315423911 + f.server * 2654435761) & 0x7FFFFFFF
            r, c = h % y.shape[0], (h >> 8) % y.shape[1]
            y = y.clone()
            if f.mode == "sign_flip":
                y[r, c] = -y[r, c]
            else:
                y[r, c] = y[r, c] * (1.0 + f.magnitude) + f.magnitude
        return y

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
