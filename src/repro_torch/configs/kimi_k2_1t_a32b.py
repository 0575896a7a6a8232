"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 routed experts top-8
+ 1 shared, first layer dense (paper-table config) [arXiv:2501.kimi2]
(copy of repro/configs/kimi_k2_1t_a32b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, vocab_size=163840,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, mlp_act="swiglu",
    num_experts=384, experts_per_token=8, num_shared_experts=1,
    first_dense_layers=1, dense_ff=18432,
    rope_theta=5e4,
)
