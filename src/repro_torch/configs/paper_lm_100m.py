"""paper-lm-100m: ~100M-param dense LM of the end-to-end training run (copy of
repro/configs/paper_lm_100m.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-lm-100m", family="dense",
    num_layers=12, d_model=768, vocab_size=32768,
    num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, mlp_act="swiglu",
    rope_theta=1e4,
)
