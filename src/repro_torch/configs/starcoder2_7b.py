"""starcoder2-7b [dense] — GQA, RoPE.
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    gated_mlp=False,             # starcoder2 uses gelu MLP
    pos="rope", rope_theta=100000.0,
    supports_long=False,
    notes="full attention; long_500k skipped (see DESIGN.md)",
)
SMOKE = CONFIG.smoke()
