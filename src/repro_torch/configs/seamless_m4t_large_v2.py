"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.
24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

The assignment's "24L" is per stack (hf card: 24 encoder + 24 decoder for
the text model); the speech frontend is a STUB — input_specs() provides
precomputed frame embeddings (B, S_src, d)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_dec=True, enc_layers=24, frontend_embeds=True,
    gated_mlp=False,             # m4t uses ReLU/GeLU FFN
    pos="rope",
    supports_long=False,
    notes="enc-dec; audio frontend stubbed per assignment",
)
SMOKE = CONFIG.smoke()
