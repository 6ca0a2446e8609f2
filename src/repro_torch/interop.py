"""Carry client and server state into the port from plain values.

The system has no weights; its state is the client's key material (the
seed, the blinding vector, the cipher record) and the servers' LU
factors. These functions build the port's objects from numpy arrays and
Python values — for instance those another SPDC implementation produced
— so the port's `keygen`, `authenticate` and `decipher` can consume
them.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cipher import CipherMeta
from .core.keygen import Key
from .core.seed import Seed
from .device import resolve_device


def seed_from_numpy(psi: float, mu: float, m_max: float, digest: bytes) -> Seed:
    """A Seed from its four fields (digest: the 32-byte SeedGen hash)."""
    digest = bytes(digest)
    if len(digest) != 32:
        raise ValueError(f"a seed digest is 32 bytes, got {len(digest)}")
    return Seed(psi=float(psi), mu=float(mu), m_max=float(m_max), digest=digest)


def key_from_numpy(v) -> Key:
    """A Key from a blinding vector (copied as float64)."""
    v = np.array(v, dtype=np.float64)
    if v.ndim != 1 or v.shape[0] < 2:
        raise ValueError(f"a blinding vector is (n,) with n >= 2, got {v.shape}")
    return Key(v=v)


def meta_from_fields(mode: str, rotate_k: int, n: int,
                     flipped: bool = False) -> CipherMeta:
    """A CipherMeta from its fields."""
    if mode not in ("ewd", "ewm"):
        raise ValueError(f"unknown EWO mode: {mode!r}")
    return CipherMeta(mode=mode, rotate_k=int(rotate_k), n=int(n),
                      flipped=bool(flipped))


def factors_from_numpy(l, u, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, U) tensors on `device` (None = the CUDA device, RuntimeError
    without one) copied from array-likes, in their own dtype."""
    device = resolve_device(device)
    l_t = torch.tensor(np.asarray(l), device=device)
    u_t = torch.tensor(np.asarray(u), device=device)
    if l_t.shape != u_t.shape or l_t.ndim not in (2, 3) \
            or l_t.shape[-1] != l_t.shape[-2]:
        raise ValueError(f"factors {tuple(l_t.shape)} and {tuple(u_t.shape)} "
                         "are not matching (…, n, n) arrays")
    return l_t, u_t
