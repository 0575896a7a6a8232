"""zamba2-7b [hybrid]: a Mamba2 backbone and ONE shared attention(+MLP)
block applied every 6 layers [arXiv:2411.15242; unverified] (copy of
repro/configs/zamba2_7b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, vocab_size=32000,
    num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, mlp_act="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
    tie_embeddings=True,
)
