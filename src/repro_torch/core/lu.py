"""LU factorization — the paper's N-server schedule (port of repro.core.lu).

The paper (§IV.D, Algorithms 1–3) computes LU *without pivoting* on the
ciphered matrix: the schedule must be value-independent (pivot choices
leak magnitudes), and the client's ε(N)-thresholded Q2/Q3 check (§IV.E)
is the guard against the resulting numerical drift.

  * lu_unblocked     — Doolittle elimination of one tile (the panel
                       kernel on CUDA).
  * lu_panel_blocked — blocked factorization of one diagonal tile: 32-wide
                       Doolittle panels, triangular-solve strips and one
                       Schur product per step (DESIGN.md §1.1).
  * lu_blocked       — right-looking block LU (panel → TRSM → Schur),
                       the sequential one-server baseline.
  * lu_nserver       — the paper's Algorithm 3: server i owns block row i,
                       computes L_{i,1..i-1}, factors X_ii, computes
                       U_{i,i+1..N}; one-way message log.
  * lu_block_row     — one server's block row of Algorithm 3 from its
                       ciphertext row and the U rows relayed from upstream
                       (what an EdgeServer computes).

On CUDA tensors the Doolittle tiles run the panel kernel
(kernels/csrc/lu_panel.cu), the strips the two triangular-solve kernels
(kernels/csrc/trsm.cu) and lu_blocked's trailing updates the Schur kernel
(kernels/csrc/schur.cu); on CPU tensors their plain versions run. lu_blocked
also runs the Schur kernel on its diagonal tiles' inner updates, which
the reference's kernel route computes inside its panel kernel. The
Schur terms of lu_nserver and lu_block_row, diagonal tiles included, are
plain matrix products, left to torch.matmul as the reference leaves them
to XLA. Every function accepts
(..., n, n) stacks and leaves its input untouched: the caller's
ciphertext must survive the factorization, because Authenticate checks
L·U against it.

Paper errata handled here (DESIGN.md §1.1): Alg. 3 line 7's inverse
right-multiplies, L_ik = (X_ik − …)·U_kk⁻¹, and line 8's Schur term is
Σ L_ik U_ki.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import ops
from .faults import apply_faults, corrupt_strip, split_plan


# ---------------------------------------------------------------------------
# one tile
# ---------------------------------------------------------------------------
def _doolittle_compact(a: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """Doolittle elimination of (..., b, b) tiles without pivoting, in the
    compact form: strict-lower multipliers + U in one array."""
    return ops.lu_panel(a, acc_dtype=acc_dtype)


def _split_compact(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L unit-lower, U upper) from the compact form; batch-aware."""
    n = a.shape[-1]
    l = torch.tril(a, -1) + torch.eye(n, dtype=a.dtype, device=a.device)
    return l, torch.triu(a)


def lu_unblocked(a: torch.Tensor, *, acc_dtype=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Doolittle LU without pivoting on (..., n, n) → (L, U), eliminated
    in acc_dtype where given. On CUDA the tile must fit one block's
    shared memory (kernels/lu_panel.py)."""
    return _split_compact(_doolittle_compact(a, acc_dtype))


def _trsm_right_upper(u: torch.Tensor, b: torch.Tensor,
                      acc_dtype=None) -> torch.Tensor:
    """Solve Z U = B → Z = B U⁻¹; batch-aware."""
    return ops.trsm_upper_right(u, b, acc_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# blocked panel — the pipeline's per-round diagonal factorization
# ---------------------------------------------------------------------------
def _matmul_update(c: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    return c - a @ b


def lu_panel_blocked(
    a: torch.Tensor, inner: int = 32, update=_matmul_update, *,
    acc_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked factorization of a (..., b, b) diagonal tile.

    Only the inner×inner sub-panels run the dependent Doolittle
    elimination; the strips beside and below each are triangular solves
    and the trailing update is one product per step, so the sequential
    chain is ceil(b/inner) panels instead of b rank-1 steps. A ragged
    tail gets a short final panel. `update(c, a, b)` returns c − a·b:
    a torch.matmul by default, ops.schur_update on lu_blocked's tiles.
    acc_dtype: the panels and strips compute in it and store at a's
    dtype (pass an `update` that does the same). Works on a copy of `a`.
    """
    b = a.shape[-1]
    if b <= inner:
        return _split_compact(_doolittle_compact(a, acc_dtype))
    a = a.clone()
    for s0 in range(0, b, inner):
        s1 = min(s0 + inner, b)
        diag = _doolittle_compact(a[..., s0:s1, s0:s1], acc_dtype)
        a[..., s0:s1, s0:s1] = diag
        if s1 < b:
            # the kernels read only the triangle they need, so the
            # compact tile serves as both L_kk and U_kk
            u_right = ops.trsm_lower(diag, a[..., s0:s1, s1:],
                                     acc_dtype=acc_dtype)
            l_below = _trsm_right_upper(diag, a[..., s1:, s0:s1], acc_dtype)
            a[..., s0:s1, s1:] = u_right
            a[..., s1:, s0:s1] = l_below
            a[..., s1:, s1:] = update(a[..., s1:, s1:], l_below, u_right)
    return _split_compact(a)


#: tile sizes >= this threshold take the blocked-panel path on the pipeline
#: critical path (below it the matmuls are too small to beat plain Doolittle)
PANEL_BLOCK_THRESHOLD = 64


def lu_diag_factor(
    a: torch.Tensor, inner: int = 32, update=_matmul_update, *,
    acc_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor a diagonal tile: blocked for b >= PANEL_BLOCK_THRESHOLD,
    one Doolittle tile below it; computed in acc_dtype where given."""
    if a.shape[-1] >= PANEL_BLOCK_THRESHOLD:
        return lu_panel_blocked(a, inner=inner, update=update,
                                acc_dtype=acc_dtype)
    return lu_unblocked(a, acc_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# blocked right-looking (the sequential one-server baseline)
# ---------------------------------------------------------------------------
def lu_blocked(
    a: torch.Tensor, block: int, *, acc_dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-looking block LU on (..., n, n); n must be divisible by block.

    Per step k over the block diagonal:
      panel:  X_kk = L_kk U_kk              (lu_diag_factor)
      trsm:   U_kj = L_kk⁻¹ X_kj (j>k);  L_ik = X_ik U_kk⁻¹ (i>k)
      schur:  X_ij -= L_ik U_kj             (i, j > k — the O(n³) bulk)

    The reference's kernel route factors each diagonal tile with one
    panel launch; the port's panel kernel holds at most a 170-wide f64
    tile, so the tile goes through lu_diag_factor, the same factorization
    in another order, with its inner updates on the Schur kernel too.

    acc_dtype: the mixed variant (DESIGN.md §6.4) — every panel, strip
    and update computes in the wider acc_dtype and stores at a's dtype:
    float32 with torch.float64, or bfloat16/float16 with torch.float32 or
    torch.float64 (kernels.routes.ROUTES; any other pair raises
    TypeError). Without it a bfloat16/float16 matrix takes the kernels'
    default routes, as the reference's kernel route does: panels and
    strips in the half type, the updates summed in float32. A diagonal tile
    of 64 or more rows is factored blocked, so its entries are rounded
    to a's dtype between its 32-wide inner steps, where the reference's
    kernel route factors the whole tile in one wide launch (ROADMAP §C).
    Leaves `a` untouched.
    """
    n = a.shape[-1]
    if n % block != 0:
        raise ValueError(f"n={n} not divisible by block={block}")
    nb = n // block

    def tile(i, j):
        return (..., slice(i * block, (i + 1) * block),
                slice(j * block, (j + 1) * block))

    blocks = [[a[tile(i, j)] for j in range(nb)] for i in range(nb)]
    l_out = torch.zeros_like(a)
    u_out = torch.zeros_like(a)
    def update(c, l, u):
        return ops.schur_update(c, l, u, acc_dtype=acc_dtype)

    for k in range(nb):
        lkk, ukk = lu_diag_factor(blocks[k][k], update=update,
                                  acc_dtype=acc_dtype)
        l_out[tile(k, k)], u_out[tile(k, k)] = lkk, ukk
        u_row = {j: ops.trsm_lower(lkk, blocks[k][j], acc_dtype=acc_dtype)
                 for j in range(k + 1, nb)}
        l_col = {i: ops.trsm_upper_right(ukk, blocks[i][k],
                                         acc_dtype=acc_dtype)
                 for i in range(k + 1, nb)}
        for j, ukj in u_row.items():
            u_out[tile(k, j)] = ukj
        for i, lik in l_col.items():
            l_out[tile(i, k)] = lik
            for j, ukj in u_row.items():
                blocks[i][j] = update(blocks[i][j], lik, ukj)
    return l_out, u_out


# ---------------------------------------------------------------------------
# the paper's N-server algorithm (Algorithm 3) with message accounting
# ---------------------------------------------------------------------------
@dataclass
class CommLog:
    """One-way communication record: (src_server, dst_server, n_elements)."""

    messages: list[tuple[int, int, int]] = field(default_factory=list)

    def send(self, src: int, dst: int, elems: int) -> None:
        self.messages.append((src, dst, elems))

    @property
    def total_elements(self) -> int:
        return sum(e for _, _, e in self.messages)

    @property
    def hops(self) -> int:
        return len(self.messages)


def nserver_comm_model(n: int, num_servers: int) -> CommLog:
    """The one-way chain's message log — a pure function of (n, N):
    server i sends every U row k <= i to server i+1."""
    b = n // num_servers
    log = CommLog()
    for i in range(num_servers - 1):
        elems = sum((num_servers - k) * b * b for k in range(i + 1))
        log.send(i, i + 1, elems)
    return log


def _corrupt_row_blocks(blocks, row_faults, *, n, b, batched, factor):
    """In-band injection for lu_nserver: corrupt one server's strip of row
    blocks in the wavefront, so downstream servers consume the corrupted
    relay (the cascading-poison threat model)."""
    defined = [j for j in range(len(blocks)) if blocks[j] is not None]
    lead = blocks[defined[0]].shape[:-2]
    full = blocks[defined[0]].new_zeros((*lead, b, n))
    for j in defined:
        full[..., :, j * b : (j + 1) * b] = blocks[j]
    for f in row_faults:
        bad = corrupt_strip(full, f, n=n, factor=factor)
        if f.matrices is not None and batched:
            idx = torch.as_tensor(f.matrices, dtype=torch.long)
            full = full.clone()
            full[idx] = bad[idx]
        else:
            full = bad
    for j in defined:
        blocks[j] = full[..., :, j * b : (j + 1) * b].contiguous()


def lu_nserver(
    x: torch.Tensor, num_servers: int, faults=()
) -> tuple[torch.Tensor, torch.Tensor, CommLog]:
    """Paper Algorithm 3 — N-server one-way pipelined block LU.

    Single-process simulation: exactly the block operations of Alg. 3 in
    the paper's order, server i computing only block row i, with the
    one-way chain's message log. Accepts (..., n, n); returns
    (L, U, comm_log).

    faults: a fault plan (core.faults). Faults marked ``in_band`` corrupt
    the faulty server's strips inside the wavefront, before the relay
    hop, so every later block row is computed against the poisoned U
    row; report-level faults are applied to the assembled factors on the
    way out (``apply_faults``).
    """
    in_band, report = split_plan(faults)
    n = x.shape[-1]
    N = num_servers
    if n % N != 0 or n // N <= 1:
        raise ValueError(
            f"n={n} must be divisible by N={N} with block > 1; augment first"
        )
    b = n // N
    X = [
        [x[..., i * b : (i + 1) * b, j * b : (j + 1) * b] for j in range(N)]
        for i in range(N)
    ]
    L = [[None] * N for _ in range(N)]
    U = [[None] * N for _ in range(N)]
    log = nserver_comm_model(n, N)

    for i in range(N):
        # L_ik for k < i (corrected right-multiply; module docstring)
        for k in range(i):
            acc = X[i][k]
            for m in range(k):
                acc = acc - L[i][m] @ U[m][k]
            L[i][k] = _trsm_right_upper(U[k][k], acc)
        # Schur update of the diagonal block, then its factorization
        acc = X[i][i]
        for k in range(i):
            acc = acc - L[i][k] @ U[k][i]
        L[i][i], U[i][i] = lu_diag_factor(acc)
        # U_ij for j > i
        for j in range(i + 1, N):
            acc = X[i][j]
            for k in range(i):
                acc = acc - L[i][k] @ U[k][j]
            U[i][j] = ops.trsm_lower(L[i][i], acc)
        # in-band faults: server i corrupts its strips before the relay
        # hop, so rows > i are computed against the poisoned U row
        row_faults = [f for f in in_band if f.server == i]
        for factor, row in (("u", U[i]), ("l", L[i])):
            hits = [f for f in row_faults if factor in f.target]
            if hits:
                _corrupt_row_blocks(row, hits, n=n, b=b,
                                    batched=x.ndim == 3, factor=factor)

    l_out = torch.zeros_like(x)
    u_out = torch.zeros_like(x)
    for i in range(N):
        for j in range(N):
            rows, cols = slice(i * b, (i + 1) * b), slice(j * b, (j + 1) * b)
            if L[i][j] is not None:
                l_out[..., rows, cols] = L[i][j]
            if U[i][j] is not None:
                u_out[..., rows, cols] = U[i][j]
    if report:
        l_out, u_out = apply_faults(l_out, u_out, report, num_servers=N)
    return l_out, u_out, log


def lu_block_row(
    x: torch.Tensor,
    u: torch.Tensor,
    server: int,
    num_servers: int,
    *,
    style: str = "nserver",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One server's block row of the Algorithm-3 factorization.

    Given the ciphertext ``x`` and factors ``u`` whose U rows above
    ``server`` are the upstream servers' (rows at or below it are masked
    out, so a corrupted strip never feeds its own recomputation), return
    the (L strip, U strip) server ``server`` reports, each (..., b, n).

    style selects the operation order:

      * "nserver"  — block-wise accumulation, bit-equal to lu_nserver's
        rows on the same device: every product multiplies the same
        contiguous (b, b) blocks lu_nserver multiplies, so the device
        library sees the same problem.
      * "pipeline" — full-row matmul accumulation, the pipeline server
        program's order (distrib.spdc_pipeline): one solve of the whole
        row, its diagonal block the factorization's U_ii.
    """
    n = x.shape[-1]
    N = num_servers
    if n % N != 0 or n // N <= 1:
        raise ValueError(f"n={n} not partitionable over N={N}")
    if not 0 <= server < N:
        raise ValueError(f"server {server} out of range for N={N}")
    if style not in ("nserver", "pipeline"):
        raise ValueError(f"unknown style {style!r}")
    b = n // N
    s0 = server * b
    x_row = x[..., s0 : s0 + b, :]
    u_above = u.clone()
    u_above[..., s0:, :] = 0
    l_row = torch.zeros_like(x_row)

    if style == "pipeline":
        for k in range(server):
            kb = k * b
            acc = x_row[..., :, kb : kb + b] - l_row @ u_above[..., :, kb : kb + b]
            ukk = u_above[..., kb : kb + b, kb : kb + b]
            l_row[..., :, kb : kb + b] = _trsm_right_upper(ukk, acc)
        s = x_row - l_row @ u_above
        lii, uii = lu_diag_factor(s[..., :, s0 : s0 + b])
        l_row[..., :, s0 : s0 + b] = lii
        u_row = ops.trsm_lower(lii, s)
        u_row[..., :, :s0] = 0
        u_row[..., :, s0 : s0 + b] = uii
        return l_row, u_row

    def blk(a, i, j):
        return a[..., i * b : (i + 1) * b, j * b : (j + 1) * b]

    def u_blk(k, j):
        # a fresh contiguous copy, laid out as lu_nserver's U[k][j]
        return blk(u_above, k, j).contiguous()

    L = [None] * N
    for k in range(server):
        acc = blk(x, server, k)
        for m in range(k):
            acc = acc - L[m] @ u_blk(m, k)
        L[k] = _trsm_right_upper(blk(u_above, k, k), acc)
        l_row[..., :, k * b : (k + 1) * b] = L[k]
    acc = blk(x, server, server)
    for k in range(server):
        acc = acc - L[k] @ u_blk(k, server)
    lii, uii = lu_diag_factor(acc)
    l_row[..., :, s0 : s0 + b] = lii
    u_row = torch.zeros_like(x_row)
    u_row[..., :, s0 : s0 + b] = uii
    for j in range(server + 1, N):
        acc = blk(x, server, j)
        for k in range(server):
            acc = acc - L[k] @ u_blk(k, j)
        u_row[..., :, j * b : (j + 1) * b] = ops.trsm_lower(lii, acc)
    return l_row, u_row


# ---------------------------------------------------------------------------
# determinant from LU
# ---------------------------------------------------------------------------
def _neumaier_sum(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Compensated (Kahan–Babuška/Neumaier) sum over the LAST axis.

    Returns host (hi, lo) arrays in x's dtype whose exact sum hi + lo
    carries the sum to ~u² relative error. The sum is O(n) and
    sequential, so it runs on the host in the reference's operation
    order rather than as n tiny device launches. Batch-aware.
    """
    arr = x.detach().cpu().numpy()
    flat = arr.reshape(-1, arr.shape[-1])
    hi = np.zeros(flat.shape[0], dtype=arr.dtype)
    lo = np.zeros(flat.shape[0], dtype=arr.dtype)
    for row, terms in enumerate(flat):
        s = c = arr.dtype.type(0)
        for xi in terms:
            t = s + xi
            # whichever operand is larger kept its bits; the smaller
            # one's truncated tail is recovered exactly
            c = c + ((s - t) + xi if abs(s) >= abs(xi) else (xi - t) + s)
            s = t
        hi[row], lo[row] = s, c
    lead = arr.shape[:-1]
    return hi.reshape(lead), lo.reshape(lead)


def slogdet_pair_from_lu(
    l: torch.Tensor, u: torch.Tensor
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sign, logabs_hi, logabs_lo) from LU factors, as host arrays — the
    compensated form: log|det| = hi + lo, recombined in float64 by the
    caller (a float32 cannot hold log|det| ≈ 1000 to 1e-4)."""
    d = (torch.diagonal(l, dim1=-2, dim2=-1)
         * torch.diagonal(u, dim1=-2, dim2=-1))
    sign = torch.prod(torch.sign(d), dim=-1).cpu().numpy()
    hi, lo = _neumaier_sum(torch.log(torch.abs(d)))
    return sign, hi, lo


def slogdet_from_lu(l: torch.Tensor, u: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(sign, log|det|) from LU factors, the pair recombined in the
    compute dtype. Batch-aware."""
    sign, hi, lo = slogdet_pair_from_lu(l, u)
    return sign, hi + lo


def det_from_lu(l: torch.Tensor, u: torch.Tensor) -> np.ndarray:
    sign, logabs = slogdet_from_lu(l, u)
    return sign * np.exp(logabs)
