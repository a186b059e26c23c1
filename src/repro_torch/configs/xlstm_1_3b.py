"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 1:7 interleave.
48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517]

d_ff=0: xLSTM blocks have no separate FFN (the block IS the channel mixer).
Recurrent state => long_500k decode applies."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    xlstm_slstm_every=8,         # 1 sLSTM per 8 blocks (1:7)
    pos="none",
    supports_long=True,
    tie_embeddings=True,
    notes="recurrent O(1) decode state; long_500k runs",
)
SMOKE = CONFIG.smoke()
