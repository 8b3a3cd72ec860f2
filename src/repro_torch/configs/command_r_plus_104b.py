"""command-r-plus-104b [dense] -- GQA, no-bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
[hf:CohereForAI/c4ai-command-r-plus; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    attn_bias=False, rope_theta=75e6,
)
