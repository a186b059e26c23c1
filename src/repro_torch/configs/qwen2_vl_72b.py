"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (backbone only).
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191; hf]

Vision frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings + (3, B, S) M-RoPE position ids."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    pos="mrope", rope_theta=1000000.0,
    frontend_embeds=True,
    loss_chunk=512,
    supports_long=False,
    notes="M-RoPE positions are model inputs; vision tower stubbed",
)
SMOKE = CONFIG.smoke()
