"""Architecture config: gemma-2b [dense] GeGLU/MQA.

The value src/repro/configs/gemma_2b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [dense] Gemma 2B: GeGLU, head_dim 256, MQA [arXiv:2403.08295] -----------
GEMMA_2B = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    pattern=(("attn_full", "mlp"),),
    mlp_type="geglu",
    notes="MQA (kv=1): KV replicated across model axis; 8 heads < 16-way "
          "model axis => sequence-parallel attention fallback",
)
