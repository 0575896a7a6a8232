"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6,
first layer dense [arXiv:2401.06066; hf] (copy of
repro/configs/deepseek_moe_16b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, vocab_size=102400,
    num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, mlp_act="swiglu",
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    first_dense_layers=1, dense_ff=10944,
    rope_theta=1e4,
)
