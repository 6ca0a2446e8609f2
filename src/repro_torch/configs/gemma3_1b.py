"""Architecture config: gemma3-1b [dense] 5:1 local:global.

The value src/repro/configs/gemma3_1b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [dense] Gemma3 1B: 5:1 local:global sliding window [hf] -----------------
GEMMA3_1B = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    pattern=(("attn_sliding", "mlp"),) * 5 + (("attn_full", "mlp"),),
    mlp_type="geglu", window=1024, rope_theta=1e6,
    long_ok=True,
    notes="26 = 4 full periods of 6 + 2 remainder (sliding) layers; "
          "single rope_theta used for local+global",
)
