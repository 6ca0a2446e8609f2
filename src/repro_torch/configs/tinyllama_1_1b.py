"""Architecture config: tinyllama-1.1b [dense] llama2-small.

The value src/repro/configs/tinyllama_1_1b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [dense] TinyLlama 1.1B: llama2 arch [arXiv:2401.02385] ------------------
TINYLLAMA_1_1B = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    pattern=(("attn_full", "mlp"),),
    mlp_type="swiglu",
)
