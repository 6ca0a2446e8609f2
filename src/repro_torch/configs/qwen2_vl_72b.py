"""Architecture config: qwen2-vl-72b [vlm] M-RoPE backbone.

The value src/repro/configs/qwen2_vl_72b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [vlm] Qwen2-VL 72B: M-RoPE text backbone [arXiv:2409.12191] -------------
QWEN2_VL_72B = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    pattern=(("attn_full", "mlp"),),
    mlp_type="swiglu", rope_type="mrope", rope_theta=1e6,
    frontend="vision", optimizer_dtype="bfloat16", grad_accum=16,
    notes="vision frontend is a stub (input_specs supplies patch "
          "embeddings); M-RoPE sections (16,24,24) on head_dim 128",
)
