"""repro_torch.linalg — differentiable secure linear algebra on one shared
LU (port of repro.linalg).

The client-facing secure-linalg family (DESIGN.md §12): `secure_slogdet`,
`secure_solve` and `secure_inv` are differentiable torch ops whose values
and gradients go through one verified outsourced factorization per
matrix (`LinalgSession`), dispatched over any transport of the port. The
Gaussian-process log-likelihood (log|Σ| and solves against Σ inside one
objective, then `.backward()`) is the workload they are shaped for.
"""
from .ops import (
    SecureLinalg,
    default_linalg,
    secure_inv,
    secure_slogdet,
    secure_solve,
)
from .session import (
    LinalgSession,
    LinalgVerificationError,
    blind_rhs,
    outsource_solve,
)

__all__ = [
    "SecureLinalg", "default_linalg",
    "secure_slogdet", "secure_solve", "secure_inv",
    "LinalgSession", "LinalgVerificationError", "blind_rhs",
    "outsource_solve",
]
