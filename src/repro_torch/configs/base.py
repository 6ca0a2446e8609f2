"""Config system: ModelConfig (architecture), ShapeConfig (workload), and
the applicability rules deciding which (arch × shape) cells run
(DESIGN.md §4).

A copy of the reference's src/repro/configs/base.py: the same fields and
defaults, the same counts, with `dtype`, `param_dtype` and `opt_dtype`
returning torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # one period of the layer pattern: ((mixer, ffn), ...)
    pattern: tuple = ((("attn_full", "mlp")),)
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    rope_theta: float = 1e4
    rope_type: str = "rope"  # rope | mrope | none
    causal: bool = True
    window: int | None = None  # sliding window / chunk size for local layers
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "dispatch"  # dense | dispatch
    moe_capacity_factor: float = 1.25
    moe_group: int = 1024  # tokens per dispatch group (bounds the one-hot)
    # ssm
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # stubs / misc
    frontend: str | None = None  # vision | audio
    long_ok: bool = False  # sub-quadratic attention => long_500k runs
    # perf knobs (§Perf hillclimb levers; defaults = paper-faithful baseline)
    attn_block: int = 1024  # KV block for blockwise attention
    attn_probs_bf16: bool = False  # cast softmax probs to bf16 before PV
    use_fsdp: bool = True  # shard params over the data axes (ZeRO-3)
    dp_over_model: bool = False  # small-model strategy: batch over BOTH mesh
    # axes (no TP; params FSDP-sharded over all 256/512 chips)
    # numerics & memory policy
    activation_dtype: str = "bfloat16"
    params_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"
    grad_accum: int = 1  # microbatch steps per train step
    remat: str = "nothing"  # nothing | dots | none
    notes: str = ""

    @property
    def dtype(self):
        return _DTYPES[self.activation_dtype]

    @property
    def param_dtype(self):
        return _DTYPES[self.params_dtype]

    @property
    def opt_dtype(self):
        return _DTYPES[self.optimizer_dtype]

    def param_count(self) -> int:
        """Total parameters (analytic, excludes vocab padding)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = 2 * v * d  # embed + head (untied)
        n_attn = sum(1 for m, _ in self.layer_list() if m != "ssm")
        n_ssm = sum(1 for m, _ in self.layer_list() if m == "ssm")
        n_mlp = sum(1 for _, fk in self.layer_list() if fk == "mlp")
        n_moe = sum(1 for _, fk in self.layer_list() if fk == "moe")
        attn = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim * d \
            + self.num_heads * self.head_dim * d
        di = self.ssm_expand * d
        ssm = 2 * d * di + 2 * d * self.ssm_state + d * self.ssm_heads \
            + 4 * (di + 2 * self.ssm_state) + 3 * self.ssm_heads + di + di * d
        gated = self.mlp_type in ("swiglu", "geglu")
        mlp = (3 if gated else 2) * d * f
        moe = self.num_experts * 3 * d * f + d * self.num_experts
        return total + n_attn * attn + n_ssm * ssm + n_mlp * mlp + n_moe * moe

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_moe = sum(1 for _, fk in self.layer_list() if fk == "moe")
        full_moe = self.num_experts * 3 * d * f
        active_moe = self.experts_per_token * 3 * d * f
        return self.param_count() - n_moe * (full_moe - active_moe)

    def layer_list(self) -> list[tuple[str, str]]:
        plen = len(self.pattern)
        full = self.num_layers // plen
        rem = self.num_layers % plen
        return list(self.pattern) * full + list(self.pattern[:rem])


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason). The 7 skips of DESIGN.md §4 are decided here."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and not cfg.long_ok:
        return False, "pure full-attention arch; 500k decode cache is not sub-quadratic-serviceable"
    return True, ""


def runnable_cells(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if cell_status(cfg, s)[0]]
