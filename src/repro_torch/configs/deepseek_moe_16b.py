"""deepseek-moe-16b [moe] -- fine-grained MoE, 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16 => MHA) d_ff=1408 (per expert) vocab=102400;
layer 0 uses a dense FFN (width 10944) per the paper.
[arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6,
    dense_ff_first=10944,
)
