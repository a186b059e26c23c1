"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf]

Period of 8 layers: attention at index 4, mamba elsewhere; MoE FF on every
2nd layer.  Hybrid recurrent+attention => long_500k decode applies (KV only
for the 1-in-8 attention layers, sharded over the data axis)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every_k=2,
    attn_every_k=8,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    pos="none",                    # jamba uses no positional encoding
    loss_chunk=512,
    supports_long=True,
    notes="1:7 attn:mamba interleave; MoE every other layer",
)
SMOKE = CONFIG.smoke()
