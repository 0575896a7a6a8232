"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]
(copy of repro/configs/phi3_mini_3_8b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, vocab_size=32064,
    num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, mlp_act="swiglu",
    rope_theta=1e4,
)
