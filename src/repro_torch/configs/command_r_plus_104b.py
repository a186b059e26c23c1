"""command-r-plus-104b [dense] — GQA, no-bias, parallel attn+FF blocks.
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    parallel_block=True,
    pos="rope", rope_theta=75000.0,
    loss_chunk=512,
    supports_long=False,
    notes="full attention; long_500k skipped (see DESIGN.md)",
)
SMOKE = CONFIG.smoke()
