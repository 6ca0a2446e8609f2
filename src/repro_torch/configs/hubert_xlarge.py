"""Architecture config: hubert-xlarge [audio] encoder-only.

The value src/repro/configs/hubert_xlarge.py registers,
copied field for field."""
from .base import ModelConfig

# -- [audio] HuBERT X-Large: encoder-only [arXiv:2106.07447] -----------------
HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    pattern=(("attn_full", "mlp"),),
    mlp_type="gelu", norm_type="layernorm", rope_type="none", causal=False,
    frontend="audio",
    notes="encoder-only (no decode shapes); conv waveform frontend is a "
          "stub (input_specs supplies frame embeddings); vocab = 504 "
          "k-means units",
)
