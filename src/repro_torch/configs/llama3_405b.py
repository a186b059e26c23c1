"""llama3-405b [dense] — GQA, 128k vocab.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256 [arXiv:2407.21783]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256,
    pos="rope", rope_theta=500000.0,
    loss_chunk=512,
    supports_long=False,
    notes="full attention; long_500k skipped (see DESIGN.md)",
)
SMOKE = CONFIG.smoke()
