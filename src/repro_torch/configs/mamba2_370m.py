"""Architecture config: mamba2-370m [ssm] SSD.

The value src/repro/configs/mamba2_370m.py registers,
copied field for field."""
from .base import ModelConfig

# -- [ssm] SSD / state-space duality [arXiv:2405.21060] ----------------------
MAMBA2_370M = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    pattern=(("ssm", "none"),),
    rope_type="none",
    ssm_state=128, ssm_heads=32, ssm_head_dim=64, ssm_expand=2,
    long_ok=True,
    notes="attention-free; decode is O(1)/token via the SSM state",
)
