"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), tied embeddings,
embeds scaled by sqrt(d_model) [arXiv:2403.08295; hf] (copy of
repro/configs/gemma_2b.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, vocab_size=256000,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_act="geglu",
    rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
)
