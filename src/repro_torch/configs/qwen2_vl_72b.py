"""qwen2-vl-72b [vlm] -- M-RoPE, dynamic resolution (backbone only).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  The vision
frontend is a stub: ``input_specs`` supplies precomputed patch embeddings.
[arXiv:2409.12191; hf Qwen/Qwen2-VL-72B]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    rope="mrope", rope_theta=1e6,
    embed_stub=True, attn_bias=True,
)
