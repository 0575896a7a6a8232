"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf] (copy of
repro/configs/qwen3_32b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, vocab_size=151936,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, mlp_act="swiglu",
    qk_norm=True, rope_theta=1e6,
)
