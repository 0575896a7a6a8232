"""Architecture config schema (port of repro/models/config.py).

The fields are the reference's, so configurations and their reduced
variants are built the same way in both packages.  The port's model runs
the dense, ssm and hybrid families (models/model.py says which features).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope: bool = False
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"      # swiglu | geglu
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    dense_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "auto"
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid
    attn_every: int = 0
    # embeddings / heads / modality
    tie_embeddings: bool = False
    embed_scale: bool = False
    num_codebooks: int = 0
    embed_inputs: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True           # activation checkpointing per layer
    remat_policy: str = "full"   # full (save nothing) | dots
    # attention impl knobs
    q_chunk: int = 2048          # the reference's q-chunk; read by nothing
                                 # here (attention runs the flash kernel)
    attn_logits_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def block_pattern(self) -> Tuple[Tuple[str, int], ...]:
        """((block_type, count), ...) of the model's composition, for the
        families the port runs (the reference's :75 covers the rest)."""
        L = self.num_layers
        if self.family == "dense":
            return (("dense", L),)
        if self.family == "ssm":
            return (("mamba", L),)
        if self.family == "hybrid":
            return (("mamba", L),
                    ("shared_attn", len(self.shared_attn_layers())))
        raise NotImplementedError(
            f"the {self.family!r} family is not ported yet (ROADMAP.md "
            f"queue 1 item 13)")

    def shared_attn_layers(self) -> Tuple[int, ...]:
        """The layers before whose mamba mixer the hybrid family's one
        shared attention+MLP block runs (every ``attn_every``-th from 0)."""
        if self.family != "hybrid" or not self.attn_every:
            return ()
        return tuple(range(0, self.num_layers, self.attn_every))
