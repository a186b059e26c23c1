"""granite-3-2b [dense] — GQA.
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
    pos="rope", rope_theta=10000.0,
    tie_embeddings=True,
    supports_long=False,
    notes="full attention; long_500k skipped (see DESIGN.md); also the "
          "base of the ~100M train example (examples/train_lm.py)",
)
SMOKE = CONFIG.smoke()
