"""Architecture config: jamba-1.5-large-398b [hybrid] 1:7 + MoE.

The value src/repro/configs/jamba_1_5_large_398b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [hybrid] Jamba 1.5 Large 398B: 1:7 attn:mamba + MoE [arXiv:2403.19887] --
JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=(
        ("attn_full", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
    ),
    mlp_type="swiglu", rope_type="none",
    num_experts=16, experts_per_token=2,
    ssm_state=128, ssm_heads=256, ssm_head_dim=64, ssm_expand=2,
    long_ok=True, optimizer_dtype="bfloat16", grad_accum=32,
    notes="period of 8 = 1 attn + 7 mamba, MoE every 2nd layer; SSM is our "
          "SSD (Mamba2) primitive standing in for Jamba's Mamba-1 (DESIGN.md "
          "§4); attention layers carry no RoPE (position from SSM), as Jamba",
)
