"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf] (copy of
repro/configs/qwen2_5_32b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, vocab_size=152064,
    num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=27648, mlp_act="swiglu",
    qkv_bias=True, rope_theta=1e6,
)
