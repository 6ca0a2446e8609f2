"""Architecture config: llama4-scout-17b-a16e [moe] 16e top-1.

The value src/repro/configs/llama4_scout_17b_a16e.py registers,
copied field for field."""
from .base import ModelConfig

# -- [moe] Llama4 Scout 17B-A16E: 16e top-1, chunked attention [hf] ----------
LLAMA4_SCOUT = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    pattern=(("attn_chunked", "moe"),) * 3 + (("attn_full", "moe"),),
    mlp_type="swiglu", num_experts=16, experts_per_token=1,
    window=8192, rope_theta=5e5, long_ok=True, grad_accum=4,
    notes="3:1 chunked-local:global (iRoPE-style, chunk 8192) => long_500k "
          "runs; shared expert omitted (backbone scope); 40 heads % 16 != 0 "
          "=> sequence-parallel attention",
)
