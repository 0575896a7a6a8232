"""mamba2-370m [ssm]: attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified] (copy of repro/configs/mamba2_370m.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
)
