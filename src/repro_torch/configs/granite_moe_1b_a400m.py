"""Architecture config: granite-moe-1b-a400m [moe] 32e top-8.

The value src/repro/configs/granite_moe_1b_a400m.py registers,
copied field for field."""
from .base import ModelConfig

# -- [moe] Granite 3.0 1B-A400M: 32e top-8 [hf:ibm-granite] ------------------
GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    pattern=(("attn_full", "moe"),),
    mlp_type="swiglu", num_experts=32, experts_per_token=8,
)
