"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf]
(copy of repro/configs/qwen2_vl_72b.py).

Transformer BACKBONE only; the vision frontend is a stub (the batch carries
precomputed patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, vocab_size=152064,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, mlp_act="swiglu",
    qkv_bias=True,            # qwen2 family uses QKV bias
    mrope=True, rope_theta=1e6,
    embed_inputs=False,       # frontend stub: precomputed embeddings
)
