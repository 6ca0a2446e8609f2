"""SPDCClient / Session — the trusted-client role of the SPDC protocol
(port of repro.api.client).

SeedGen, KeyGen, Cipher, Authenticate and Decipher run on the client;
only the Parallelize stage (the N-server LU) runs on untrusted edge
hardware:

    client  = SPDCClient(method="q3", dtype="float64")
    session = client.open_session(m, num_servers=4)      # PMOP runs here
    result  = session.run()                              # servers + verify

`open_session` performs the PMOP (seed → key → cipher → equilibrate →
det-preserving border) and keeps every secret on the Session: seeds,
blinding keys, rotation metadata, and the augmented ciphertext the
probes verify against. `Session.collect()` authenticates the factors
with a secret-keyed probe and deciphers.

Ported here: one matrix and same-size stacks on the inline transport.
Mixed-size lists (ROADMAP A11), fault plans and recovery (A8), rateless
dispatch (A9) and per-server messages (A7) raise NotImplementedError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.augment import augment, border_rng, padding_for_servers
from ..core.cipher import CipherMeta, cipher, cipher_batch
from ..core.cipher import equilibrate as ced_equilibrate
from ..core.decipher import decipher, decipher_batch
from ..core.keygen import keygen, keygen_batch
from ..core.lu import nserver_comm_model
from ..core.seed import Seed, seedgen, seedgen_batch
from ..core.verify import authenticate
from ..device import resolve_device, synchronize
from .inline import resolve_transport

__all__ = ["SPDCClient", "Session"]

_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.float16: np.float16}


def _equilibrate_augment(x, rng, *, padding, equilibrate):
    """PMOP tail: optional two-sided power-of-two equilibration, then the
    det-preserving [[X,0],[R,I]] border. Both are exact in floating
    point. Returns (x_aug, log2_scale as a host array)."""
    if equilibrate:
        x, log2_scale = ced_equilibrate(x)
        log2_scale = log2_scale.cpu().numpy()
    else:
        log2_scale = np.zeros(x.shape[:-2], dtype=np.int32)
    return augment(x, padding, rng=rng), log2_scale


@dataclass
class SPDCClient:
    """The trusted client role: holds the security configuration and
    mints Sessions; per-matrix secrets live on the Session.

    Parameters mirror `core.protocol.outsource_determinant`. `device` is
    where the client's sessions compute: None means the CUDA device and
    raises RuntimeError without one; "cpu" runs the plain path.
    """

    lambda1: int = 128
    lambda2: int = 128
    mode: str = "ewd"
    method: str = "q3"
    faithful_sign: bool = False
    recover: bool = False
    dtype: Any = "float64"
    growth_safe: bool | None = None
    equilibrate: bool | None = None
    rateless: Any = False
    #: default transport of this client's sessions (None = inline)
    transport: Any = None
    device: Any = None

    def __post_init__(self):
        from ..core.protocol import _resolve_growth_controls, resolve_dtype

        if self.recover:
            raise NotImplementedError("verification-driven recovery: ROADMAP A8")
        if self.rateless:
            raise NotImplementedError("rateless dispatch: ROADMAP A9")
        self.device = resolve_device(self.device)
        self.transport = resolve_transport(self.transport)
        self.dtype = resolve_dtype(self.dtype)
        self.growth_safe, self.equilibrate = _resolve_growth_controls(
            self.dtype, self.growth_safe, self.equilibrate,
            self.faithful_sign,
        )

    def _host_copy(self, m) -> np.ndarray:
        """The plaintext as a host array in the compute dtype — what
        SeedGen hashes, bit for bit the reference's `np.asarray(m)`."""
        if self.dtype not in _NUMPY_DTYPES:
            raise ValueError(f"no host dtype for {self.dtype}")
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        # copies only when the dtype or layout differs (nothing downstream
        # writes to the plaintext), or when the buffer is read-only, which
        # torch.from_numpy does not take
        host = np.ascontiguousarray(m, dtype=_NUMPY_DTYPES[self.dtype])
        return host if host.flags.writeable else host.copy()

    # -- PMOP: everything before any server is involved ---------------------

    def open_session(self, m, num_servers: int, *, faults=None,
                     tamper=None) -> "Session":
        """Run the client-side PMOP and return the dispatchable Session.

        m: one (n, n) matrix or a (B, n, n) stack. tamper is a client-side
        hook on the assembled factors (models a malicious server).
        """
        if isinstance(m, (list, tuple)):
            raise NotImplementedError("mixed-size lists: ROADMAP A11")
        if faults:
            raise NotImplementedError("fault plans: ROADMAP A8")
        t0 = time.perf_counter()
        m_host = self._host_copy(m)
        m_dev = torch.from_numpy(m_host).to(self.device)
        if m_host.ndim == 3 and m_host.shape[-1] == m_host.shape[-2]:
            sess = self._open_batch(m_dev, m_host, num_servers, tamper)
        elif m_host.ndim == 2 and m_host.shape[0] == m_host.shape[1]:
            sess = self._open_single(m_dev, m_host, num_servers, tamper)
        else:
            raise ValueError(
                f"expected a square matrix or a (B, n, n) stack, got {m_host.shape}"
            )
        synchronize(self.device)
        sess._pmop_s = time.perf_counter() - t0
        return sess

    def _open_single(self, m, m_host, num_servers, tamper) -> "Session":
        n = int(m.shape[0])
        seed = seedgen(self.lambda1, m_host)
        key = keygen(self.lambda2, seed, n)
        x, meta = cipher(m, key, seed, mode=self.mode,
                         growth_safe=self.growth_safe)
        padding = padding_for_servers(n, num_servers)
        x_aug, log2_scale = _equilibrate_augment(
            x, border_rng(seed.digest), padding=padding,
            equilibrate=self.equilibrate,
        )
        return Session(
            client=self, kind="single", num_servers=num_servers,
            x_aug=x_aug, seeds=[seed], metas=[meta],
            log2_scale=float(log2_scale), n=n, padding=padding,
            digest=seed.digest, tamper=tamper,
        )

    def _open_batch(self, m, m_host, num_servers, tamper) -> "Session":
        from ..core.protocol import _batch_digest

        n = int(m.shape[-1])
        seeds = seedgen_batch(self.lambda1, m_host)
        v = keygen_batch(self.lambda2, seeds, n)
        x, metas = cipher_batch(m, v, seeds, mode=self.mode,
                                growth_safe=self.growth_safe)
        padding = padding_for_servers(n, num_servers)
        x_aug, log2_scale = _equilibrate_augment(
            x, border_rng(seeds[0].digest), padding=padding,
            equilibrate=self.equilibrate,
        )
        return Session(
            client=self, kind="batch", num_servers=num_servers,
            x_aug=x_aug, seeds=seeds, metas=metas,
            log2_scale=log2_scale, n=n, padding=padding,
            digest=_batch_digest(seeds), tamper=tamper,
        )


@dataclass
class Session:
    """One protocol run: the client's secrets and the dispatchable
    ciphertext. Everything here is client-private."""

    client: SPDCClient
    kind: str  # "single" | "batch"
    num_servers: int
    x_aug: torch.Tensor  # (…, n', n') augmented CIPHERTEXT (client-held)
    seeds: list[Seed]
    metas: list[CipherMeta]
    log2_scale: Any
    n: int  # raw size
    padding: int
    digest: bytes
    tamper: Any = None
    # phase timings feeding SPDCReport.timings
    _pmop_s: float = 0.0
    _dispatch_s: float = 0.0

    @property
    def n_aug(self) -> int:
        return int(self.x_aug.shape[-1])

    def run(self, transport=None):
        """Dispatch the Parallelize stage through a transport (default:
        the client's), then collect."""
        transport = (self.client.transport if transport is None
                     else resolve_transport(transport))
        t0 = time.perf_counter()
        l, u = transport.sweep(self.x_aug, self.num_servers)
        synchronize(self.x_aug.device)
        self._dispatch_s = time.perf_counter() - t0
        return self.collect((l, u))

    def collect(self, results):
        """Authenticate → Decipher over an (L, U) pair of full factors.
        Returns core.protocol.SPDCResult / SPDCBatchResult."""
        from ..core.protocol import (
            SessionTimings, SPDCBatchResult, SPDCReport, SPDCResult,
            _probe_rng,
        )

        t_collect = time.perf_counter()
        l, u = results
        if self.tamper is not None:
            l, u = self.tamper(l, u)
        verdict = authenticate(
            l, u, self.x_aug, num_servers=self.num_servers,
            method=self.client.method, rng=_probe_rng(self.digest),
        )
        comm = nserver_comm_model(self.n_aug, self.num_servers)

        def build_report() -> SPDCReport:
            collect_s = time.perf_counter() - t_collect
            return SPDCReport(
                verdict=verdict,
                timings=SessionTimings(
                    pmop_s=self._pmop_s,
                    dispatch_s=self._dispatch_s,
                    collect_s=collect_s,
                    total_s=self._pmop_s + self._dispatch_s + collect_s,
                ),
            )

        if self.kind == "single":
            det = decipher(self.seeds[0], self.metas[0], l, u,
                           faithful=self.client.faithful_sign,
                           log2_scale=self.log2_scale)
            return SPDCResult(
                det=det,
                verified=bool(np.all(verdict.ok)),
                residual=verdict.residual,
                seed=self.seeds[0],
                meta=self.metas[0],
                comm=comm,
                padding=self.padding,
                num_servers=self.num_servers,
                report=build_report(),
            )
        dets = decipher_batch(self.seeds, self.metas, l, u,
                              faithful=self.client.faithful_sign,
                              log2_scale=np.asarray(self.log2_scale))
        return SPDCBatchResult(
            dets=dets,
            verified=np.atleast_1d(np.asarray(verdict.ok)),
            residual=np.atleast_1d(np.asarray(verdict.residual)),
            seeds=self.seeds,
            metas=self.metas,
            comm=comm,
            padding=self.padding,
            num_servers=self.num_servers,
            report=build_report(),
        )
