"""Architecture config: nemotron-4-340b [dense] GQA + squared-ReLU.

The value src/repro/configs/nemotron_4_340b.py registers,
copied field for field."""
from .base import ModelConfig

# -- [dense] Nemotron-4 340B: GQA kv=8, squared-ReLU [arXiv:2402.16819] ------
NEMOTRON_4_340B = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    pattern=(("attn_full", "mlp"),),
    mlp_type="relu2",
    optimizer_dtype="bfloat16", grad_accum=32,
    notes="bf16 optimizer state + 16-way grad accumulation to fit 340B "
          "training state in 256x16GB (DESIGN.md §5)",
)
