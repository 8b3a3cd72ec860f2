"""jamba-v0.1-52b [hybrid] -- Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2, MoE every other layer, attention at position 4 of each 8-layer
block, ssm_state=16.  [arXiv:2403.19887; hf ai21labs/Jamba-v0.1]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_every=8, attn_position=4,
    sub_quadratic=True,
)
