"""Feed-forward variants: SwiGLU / GeGLU (gated), squared-ReLU / GELU
(non-gated).

Port of src/repro/models/mlp.py. The products stay `torch.matmul`, as the
reference leaves them to XLA; on one device its sharding constraints are
no-ops and are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Initializer


def _gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


GATED = {"swiglu": F.silu, "geglu": _gelu}
PLAIN = {"relu2": lambda x: torch.square(F.relu(x)), "gelu": _gelu}


class MLP(nn.Module):
    """w_gate (d, f), w_up (d, f), w_down (f, d) — w_gate only when gated."""

    def __init__(self, ini: Initializer, cfg, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
        if cfg.mlp_type in GATED:
            self.w_gate = ini.normal((d, f))
        self.w_up = ini.normal((d, f))
        self.w_down = ini.normal((f, d), std=std_o)


def init_mlp(ini: Initializer, cfg, d_ff: int | None = None) -> MLP:
    return MLP(ini, cfg, d_ff)


def apply_mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_type in GATED:
        h = GATED[cfg.mlp_type](x @ p.w_gate) * (x @ p.w_up)
    else:
        h = PLAIN[cfg.mlp_type](x @ p.w_up)
    return h @ p.w_down
