"""falcon-mamba-7b [ssm] -- attention-free mamba-1 architecture.

64L d_model=4096 vocab=65024 ssm_state=16 (d_inner=8192, conv=4, expand=2).
[arXiv:2410.05355; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    rope="none", sub_quadratic=True,
)
