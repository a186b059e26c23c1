"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.
61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840
[arXiv:2501.kimi2 (paper-table); unverified]

Shared-expert FF (DeepSeek-V3 lineage) + 384 routed experts/layer:
61 x 384 x 3 x 7168 x 2048 = 1.01e12 routed params (the "1T");
top-8 + shared ~= 32B active (the "a32b")."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    moe_experts=384, moe_top_k=8, moe_d_ff=2048, moe_shared_ff=True,
    pos="rope", rope_theta=50000.0,
    loss_chunk=512,
    supports_long=False,
    notes="EP stress test: 384 experts over 16-way model axis = 24/device",
)
SMOKE = CONFIG.smoke()
