"""Dispatch-channel keys of the role-split protocol (port of the
`dispatch_subseed` part of repro.distrib.recovery).

Verification-driven recovery itself — `recover_lu`, `ServerPool`,
`rederive_shard` — is not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import hashlib
import struct


def dispatch_subseed(digest: bytes, server: int, attempt: int) -> bytes:
    """Fresh per-dispatch sub-seed: H(Ψ-digest ‖ server ‖ attempt).

    Re-keys the client → server channel so a replayed or stale shard
    cannot impersonate a re-dispatch. Derived, never stored: the client
    keeps only Ψ's digest.
    """
    h = hashlib.sha256()
    h.update(digest)
    h.update(struct.pack(">qq", int(server), int(attempt)))
    return h.digest()
