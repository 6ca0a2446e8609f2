"""Silent-data-corruption (SDC) detection via Freivalds projection checks.

Port of src/repro/core/sdc.py. The paper's Q2 is a scalar Freivalds
check specialised to LU; the same O(n²) projection verifies any claimed
product C = A·B, which is the integrity question a training fleet has of
a silently corrupting core:

  * freivalds_residual(a, b, c, key)  — relative |A(Br) − Cr| / |Cr|
  * sdc_flag(residual)                — the residual past 1e3·eps
  * checked_matmul(a, b, key)         — the product and its residual
  * check_step_outputs(triples, key)  — the largest residual of many claims

The probe r is a Rademacher vector (±1) drawn by a `torch.Generator` on
the operands' device: `key` is that generator, or an int that seeds a
new one there. The reference draws it with `jax.random.rademacher`, which
torch cannot replay, so the two packages draw other signs from one seed
(ROADMAP §C); the residual's law is the same.
"""
from __future__ import annotations

import torch


def _generator(key, device: torch.device) -> torch.Generator:
    """`key` itself if it is a generator on `device`, else a new one there
    seeded with the int `key`."""
    if isinstance(key, torch.Generator):
        if torch.device(key.device).type != device.type:
            raise ValueError("the probe's generator is not on the operands' "
                             "device")
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def rademacher(n: int, key, *, dtype, device) -> torch.Tensor:
    """n signs ±1 in `dtype`, each with probability ½."""
    device = torch.device(device)
    bits = torch.randint(0, 2, (n,), generator=_generator(key, device),
                         device=device)
    return (2 * bits - 1).to(dtype)


def freivalds_residual(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       key) -> torch.Tensor:
    """Relative scalar residual of the claim C = A @ B (last two dims):
    ||A(Br) − Cr|| / (||Cr|| + 1e-30), a 0-d tensor in c's dtype."""
    r = rademacher(b.shape[-1], key, dtype=c.dtype, device=c.device)
    lhs = a @ (b @ r)
    rhs = c @ r
    return torch.linalg.norm(lhs - rhs) / (torch.linalg.norm(rhs) + 1e-30)


def sdc_flag(residual: torch.Tensor, *, dtype=None, c: float = 1e3) -> torch.Tensor:
    """True iff the residual exceeds the roundoff-scaled acceptance bound
    c·eps of `dtype` (default the residual's)."""
    return residual > c * torch.finfo(dtype or residual.dtype).eps


def checked_matmul(a: torch.Tensor, b: torch.Tensor,
                   key) -> tuple[torch.Tensor, torch.Tensor]:
    """C = A @ B and its Freivalds residual."""
    c = a @ b
    return c, freivalds_residual(a, b, c, key)


def check_step_outputs(triples, key) -> torch.Tensor:
    """The largest residual over an iterable of (A, B, C) claims (e.g.
    one per layer); each claim draws its own probe, in turn, from one
    generator (the reference splits its key once per claim)."""
    triples = list(triples)
    if not triples:
        return torch.zeros(())
    gen = _generator(key, triples[0][2].device)
    return torch.stack([freivalds_residual(a, b, c, gen)
                        for a, b, c in triples]).max()
