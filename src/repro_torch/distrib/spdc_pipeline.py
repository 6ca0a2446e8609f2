"""Distributed N-server SPDC LU — the paper's Algorithm 3 on a mesh of
server slots (port of repro.distrib.spdc_pipeline).

Mapping (DESIGN.md §2): edge server i ⇒ slot i of a ServerMesh. A slot is
a device and, on CUDA, a stream of its own. Server i owns block row i of
the ciphered matrix: its (B, b, n) rows are copied onto its slot before
the first round, and no slot ever holds another server's rows of X. The
paper's one-way communication — S_i sends its accumulated U rows only to
S_{i+1} — is one relay hop per slot per round: a device copy from slot
i's relay buffer into slot (i+1) % N's receive buffer, run on the
receiver's stream after an event of the sender's. Neighbour-only traffic,
no broadcast; the L and U rows meet only when the factors are gathered
for the client at the end.

Program structure (N rounds; the reference's SPMD programs, one Python
loop over the slots here):

  round t: slot t runs its Alg.-3 row computation on its own stream
           (L_{t,k} for k < t by TRSM against the upstream U; the Schur
           term of the whole row; the blocked factorization of the
           diagonal block; the U row by one triangular solve) and writes
           its U row into its relay buffer; the passive slots launch
           nothing. Then every slot forwards its buffer one hop down the
           ring.

The reference gates the row computation with `lax.cond` on the axis index
and forwards with `lax.ppermute`, which moves every device's buffer in
every round. The hops here are the same, the stale ones and the wrap hop
N−1 → 0 included: the stream program's factors depend on what passive
slots forward, and the hop log (`ServerMesh.hops`) is held to the
reference's message sizes.

Programs: "baseline" relays the whole (B, n, n) buffer in each of the N
rounds; "exact" relays rows 0..t in rounds 0..N−2 (the paper's message
contents); "stream" computes against the received rows only, Schur terms
of depth t·b instead of n, and relays them with the active row appended.

Batch semantics (DESIGN.md §3): (n, n) or (B, n, n) inputs; the batch
dimension stays on each slot, so one N-round sweep factors the stack.

Buffers: each slot has a relay buffer and a receive buffer, (B, n, n)
each, swapped after every hop, so a slot never receives into the buffer
it is still sending from. A receiver also waits for its downstream
neighbour's event before it overwrites its receive buffer (which that
neighbour read as the relay buffer a round earlier): a write-after-read
order; no data moves upstream. A buffer read by a neighbour's stream is
marked with `record_stream`, so the caching allocator does not hand its
memory out while that stream may still read it.

Kernels: the row computation runs the port's kernels on the slot's stream
(every wrapper launches on torch.cuda.current_stream()): the TRSM kernels
(csrc/trsm.cu) for L_{t,k}, the panel strips and the whole-row solve, the
panel kernel (csrc/lu_panel.cu) for the diagonal tiles. The Schur terms
are torch.matmul, as the reference leaves them to XLA and the port's
lu_nserver to torch. On CPU slots the plain versions run.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..core.faults import corrupt_strip, normalize_plan
from ..core.lu import _trsm_right_upper, lu_diag_factor
from ..device import resolve_device
from ..kernels import ops

__all__ = ["Hop", "ServerMesh", "Slot", "lu_nserver_shardmap",
           "pipeline_collective_bytes"]

#: profiler ranges: the scatter of X's block rows, each active slot's row
#: computation ("…slot{i}") and each round's relay hops
SCATTER_RANGE = "spdc_pipeline.scatter"
SLOT_RANGE = "spdc_pipeline.slot"
RELAY_RANGE = "spdc_pipeline.relay"


@dataclass(frozen=True)
class Slot:
    """One edge server's place on the mesh: its device and, on CUDA, the
    stream its work runs on."""

    index: int
    device: torch.device
    stream: torch.cuda.Stream | None = None

    def scope(self):
        """The context that puts work on this slot's stream (none on the
        CPU)."""
        return (nullcontext() if self.stream is None
                else torch.cuda.stream(self.stream))

    def event(self):
        """An event recorded on this slot's stream now (None on the CPU)."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def wait(self, event) -> None:
        """Order this slot's later work after `event`."""
        if event is not None:
            self.stream.wait_event(event)


@dataclass(frozen=True)
class Hop:
    """One relay copy: in `round`, slot `src` sent `nbytes` to `dst`."""

    round: int
    src: int
    dst: int
    nbytes: int


class ServerMesh:
    """N server slots; the counterpart of the reference's 1-D "servers"
    mesh.

    device: None or a CUDA device puts slot i on CUDA device (k + i) %
    device_count, k the device's index (0 for None), each slot with a
    stream of its own (streams=False: every slot on its device's current
    stream); "cpu" gives N CPU slots. Several slots may share one card:
    they share its memory, and the relay copies stay device copies.

    `hops` is the hop log of the last sweep, in launch order; a sweep
    holds `lock`, so concurrent sweeps on one mesh run one at a time.
    """

    def __init__(self, num_servers: int, device=None, *, streams: bool = True):
        if num_servers < 1:
            raise ValueError(f"a mesh needs at least one slot, got {num_servers}")
        device = resolve_device(device)
        slots = []
        for i in range(num_servers):
            if device.type == "cuda":
                dev = torch.device("cuda", ((device.index or 0) + i)
                                   % torch.cuda.device_count())
                stream = (torch.cuda.Stream(dev) if streams
                          else torch.cuda.current_stream(dev))
                slots.append(Slot(i, dev, stream))
            else:
                slots.append(Slot(i, device))
        self.slots: tuple[Slot, ...] = tuple(slots)
        self.hops: list[Hop] = []
        self.lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.slots)


class _Server:
    """One slot's state during a sweep: its block row of X, its L and U
    strips, and its relay and receive buffers, all allocated on the
    slot's stream."""

    def __init__(self, slot: Slot, x_row: torch.Tensor, n: int):
        self.slot = slot
        self.x_row = x_row
        shape = x_row.shape
        self.l_row = torch.zeros(shape, dtype=x_row.dtype, device=slot.device)
        self.u_row = torch.zeros(shape, dtype=x_row.dtype, device=slot.device)
        self.buf, self.recv = (
            torch.zeros((shape[0], n, n), dtype=x_row.dtype,
                        device=slot.device)
            for _ in range(2))


def _active_row(srv: _Server, t: int, b: int, u_rows: torch.Tensor) -> None:
    """Slot t's block row of Algorithm 3 against the U rows it holds.

    u_rows: (B, K, n), the upstream U rows — the whole relay buffer
    (K = n) for baseline and exact, the received rows (K = t·b) for
    stream — so the Schur terms are products of depth K, as in the
    reference's programs. Fills srv.l_row and srv.u_row and writes the U
    row into the relay buffer.

    The U row is L_ii⁻¹ S of the whole row, as in the reference, except
    its diagonal block: the reference keeps the solve's L_ii⁻¹ S_ii there
    and drops the factorization's U_ii; here U_ii is kept, as lu_nserver
    keeps it. The two are equal in exact arithmetic, but under the
    element growth of a rotated ciphertext the solve's pivots drift, and
    with them log|det| (ROADMAP §C)."""
    x_row, l_row = srv.x_row, srv.l_row
    depth = u_rows.shape[1]
    l_k = l_row[:, :, :depth]
    for k in range(t):
        kb = k * b
        acc = x_row[:, :, kb:kb + b] - l_k @ u_rows[:, :, kb:kb + b]
        l_row[:, :, kb:kb + b] = _trsm_right_upper(
            u_rows[:, kb:kb + b, kb:kb + b], acc)
    s = x_row - l_k @ u_rows if depth else x_row
    ib = t * b
    lii, uii = lu_diag_factor(s[:, :, ib:ib + b])
    l_row[:, :, ib:ib + b] = lii
    r = ops.trsm_lower(lii, s)
    # the pivots come from the factorization (ROADMAP §C)
    r[:, :, ib:ib + b] = uii
    keep = torch.arange(r.shape[-1], device=r.device) >= ib
    zero = r.new_zeros(())
    torch.where(keep, r, zero, out=srv.u_row)
    # the relayed copy is written by the same elementwise kernel, not a
    # device copy: the relay's hops stay the sweep's only copies
    torch.where(keep, r, zero, out=srv.buf[:, ib:ib + b])


def _relay(mesh: ServerMesh, servers: list[_Server], t: int, rows: int) -> None:
    """Round t's hops: every slot i sends rows 0..rows of its relay
    buffer to slot (i + 1) % N, whatever they hold; then each slot swaps
    its buffers. The copy runs on the receiver's stream, after the
    sender's event (its buffer is final for the round) and the
    downstream neighbour's (it has read the buffer being reused)."""
    N = len(servers)
    ready = [srv.slot.event() for srv in servers]
    with record_function(RELAY_RANGE):
        for j, dst in enumerate(servers):
            src = servers[(j - 1) % N]
            dst.slot.wait(ready[(j - 1) % N])
            dst.slot.wait(ready[(j + 1) % N])
            with dst.slot.scope():
                dst.recv[:, :rows].copy_(src.buf[:, :rows])
            sent = src.buf[:, :rows]
            mesh.hops.append(Hop(t, src.slot.index, dst.slot.index,
                                 sent.numel() * sent.element_size()))
    for srv in servers:
        srv.buf, srv.recv = srv.recv, srv.buf


def _program_baseline(mesh, servers, n, b):
    """The fixed-shape relay: the whole buffer, every round."""
    for t, srv in enumerate(servers):
        with srv.slot.scope(), record_function(f"{SLOT_RANGE}{t}"):
            _active_row(srv, t, b, srv.buf)
        _relay(mesh, servers, t, n)


def _program_exact(mesh, servers, n, b):
    """The exact relay: rows 0..t in rounds 0..N−2, (t+1)·b×n elements a
    hop instead of n×n, the paper's §IV.D.3 message contents."""
    for t, srv in enumerate(servers):
        with srv.slot.scope(), record_function(f"{SLOT_RANGE}{t}"):
            _active_row(srv, t, b, srv.buf)
        if t + 1 < len(servers):
            _relay(mesh, servers, t, (t + 1) * b)


def _program_stream(mesh, servers, n, b):
    """The streaming relay: the active slot computes against the t·b
    rows it received, then the received rows and its own are relayed.
    Passive slots forward the rows they were relayed: stale until a slot
    is about to activate, when it holds the genuine rows 0..t of its true
    upstream chain."""
    for t, srv in enumerate(servers):
        with srv.slot.scope(), record_function(f"{SLOT_RANGE}{t}"):
            _active_row(srv, t, b, srv.buf[:, :t * b])
        if t + 1 < len(servers):
            _relay(mesh, servers, t, (t + 1) * b)


_PROGRAMS = {
    "baseline": _program_baseline,
    "exact": _program_exact,
    "stream": _program_stream,
}


def _inject_faults(srv: _Server, faults, *, n: int, batched: bool) -> None:
    """Device-output fault injection (core.faults surface, distributed
    leg): the slot playing a faulty server corrupts (or zeroes) the
    strips it reports; the other slots' strips pass through untouched.
    In-band relay poisoning is not modelled here (core.lu.lu_nserver)."""
    for f in faults:
        if f.server != srv.slot.index:
            continue
        targets = ("l", "u") if f.kind == "dropout" else tuple(f.target)
        for factor in ("l", "u"):
            if factor not in targets:
                continue
            orig = srv.l_row if factor == "l" else srv.u_row
            bad = corrupt_strip(orig, f, n=n, factor=factor)
            if f.matrices is not None and batched:
                idx = torch.as_tensor(f.matrices, dtype=torch.long,
                                      device=orig.device)
                hit, bad = bad, orig.clone()
                bad[idx] = hit[idx]
            if factor == "l":
                srv.l_row = bad
            else:
                srv.u_row = bad


def _sweep(mesh: ServerMesh, x: torch.Tensor, program: str, faults):
    """One sweep of `program` over the mesh's slots (see module
    docstring); returns the gathered (L, U) on x's device."""
    N = mesh.size
    n = x.shape[-1]
    b = n // N
    batched = x.ndim == 3
    xs = x if batched else x.unsqueeze(0)
    mesh.hops = []
    with record_function(SCATTER_RANGE):
        servers = []
        for slot in mesh.slots:
            if slot.stream is not None and x.is_cuda:
                # X's rows are read after the caller's queued work on X
                slot.stream.wait_stream(torch.cuda.current_stream(x.device))
            with slot.scope():
                row = xs[:, slot.index * b:(slot.index + 1) * b, :].to(
                    slot.device, copy=True, memory_format=torch.contiguous_format)
                servers.append(_Server(slot, row, n))
    for i, srv in enumerate(servers):
        reader = servers[(i + 1) % N].slot.stream
        if reader is not None and reader != srv.slot.stream:
            for buf in (srv.buf, srv.recv):
                buf.record_stream(reader)
    _PROGRAMS[program](mesh, servers, n, b)
    if faults:
        for srv in servers:
            with srv.slot.scope():
                _inject_faults(srv, faults, n=n, batched=batched)
    # the gather runs on the current streams, after every slot's work
    for srv in servers:
        if srv.slot.stream is not None:
            here = torch.cuda.current_stream(srv.slot.device)
            here.wait_stream(srv.slot.stream)
            if x.is_cuda and x.device != srv.slot.device:
                torch.cuda.current_stream(x.device).wait_stream(srv.slot.stream)
            for strip in (srv.l_row, srv.u_row):
                strip.record_stream(here)
    l = torch.cat([srv.l_row.to(x.device) for srv in servers], dim=-2)
    u = torch.cat([srv.u_row.to(x.device) for srv in servers], dim=-2)
    if not batched:
        return l[0], u[0]
    return l, u


def lu_nserver_shardmap(
    x: torch.Tensor, num_servers: int, *, mesh: ServerMesh | None = None,
    program: str = "baseline", faults=(), device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed Alg. 3. x: (n, n) or (B, n, n) with n % num_servers == 0.

    program: one of "baseline" (fixed-shape relay), "exact" (paper-exact
    relay), "stream" (no relay of the whole buffer; received rows only).
    The batch dimension, if present, stays on each slot — one sweep
    factors the whole stack (DESIGN.md §3).

    faults: a fault plan (core.faults) injected at the slot-output level:
    the slot playing each faulty server corrupts (or zeroes) the strips
    it reports. Delay faults must be resolved by the caller
    (core.faults.resolve_delays); in-band relay poisoning is only
    modelled by the single-process simulation and is rejected here.

    mesh: an existing ServerMesh of num_servers slots; by default one is
    built on `device` (None = the CUDA device, "cpu" for the plain path).
    The factors come back on x's device.

    (The reference's deprecated `exact_relay=` is gone in both packages:
    passing it raises TypeError.)
    """
    if program not in _PROGRAMS:
        raise ValueError(
            f"unknown program {program!r}; expected one of {sorted(_PROGRAMS)}"
        )
    faults = normalize_plan(faults)
    if any(f.in_band for f in faults):
        raise ValueError(
            "in_band faults are not modeled by the shard_map pipeline; use "
            "core.lu.lu_nserver for relay-poisoning simulation"
        )
    if any(f.kind == "delay" for f in faults):
        raise ValueError(
            "resolve delay faults first (core.faults.resolve_delays)"
        )
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be (n, n) or (B, n, n), got shape {tuple(x.shape)}")
    if n % num_servers != 0 or n // num_servers <= 1:
        raise ValueError(f"n={n} not partitionable over N={num_servers}; augment first")
    if mesh is None:
        mesh = ServerMesh(num_servers, device)
    elif mesh.size != num_servers:
        raise ValueError(
            f"the mesh has {mesh.size} slots, the sweep needs {num_servers}")
    with mesh.lock:
        return _sweep(mesh, x, program, faults)


def pipeline_collective_bytes(n: int, num_servers: int, itemsize: int = 8) -> dict:
    """Communication model: fixed-shape relay vs the paper's exact volume."""
    relay = num_servers * n * n * itemsize  # one (n,n) hop per round
    paper = sum(
        sum((num_servers - k) for k in range(i + 1)) * (n // num_servers) ** 2
        for i in range(num_servers - 1)
    ) * itemsize
    return {"relay_bytes": relay, "paper_exact_bytes": paper,
            "overcount_factor": relay / max(paper, 1)}
