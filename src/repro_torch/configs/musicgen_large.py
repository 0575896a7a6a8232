"""musicgen-large [audio] — decoder-only over EnCodec tokens, 4 parallel
codebooks (delay-pattern scheduling out of scope; frontend stubbed)
[arXiv:2306.05284; hf] (copy of repro/configs/musicgen_large.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, vocab_size=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, mlp_act="swiglu",
    num_codebooks=4,
    rope_theta=1e4,
)
