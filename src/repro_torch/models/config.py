"""Architecture config schema (port of repro/models/config.py).

The fields are the reference's, so configurations and their reduced
variants are built the same way in both packages, and the parameter
accounting is the reference's (``param_count``, ``active_param_count``).
The port's model runs every family (models/model.py).
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

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-shared-attn)."""
        return self.family in ("ssm", "hybrid")

    def block_pattern(self) -> Tuple[Tuple[str, int], ...]:
        """((block_type, count), ...) of the model's composition."""
        L = self.num_layers
        if self.family in ("dense", "vlm", "audio"):
            return (("dense", L),)
        if self.family == "moe":
            fd = self.first_dense_layers
            return (("dense", fd), ("moe", L - fd)) if fd else (("moe", L),)
        if self.family == "ssm":
            return (("mamba", L),)
        if self.family == "hybrid":
            return (("mamba", L),
                    ("shared_attn", len(self.shared_attn_layers())))
        raise ValueError(self.family)

    def shared_attn_layers(self) -> Tuple[int, ...]:
        """The layers before whose mamba mixer the hybrid family's one
        shared attention+MLP block runs (every ``attn_every``-th from 0)."""
        if self.family != "hybrid" or not self.attn_every:
            return ()
        return tuple(range(0, self.num_layers, self.attn_every))

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count, the reference's (``block_params``)."""
        D, V = self.d_model, self.vocab_size
        n_embed = max(self.num_codebooks, 1)
        total = n_embed * V * D
        if not self.tie_embeddings:
            total += n_embed * V * D
        total += D  # final norm
        for kind, count in self.block_pattern():
            # the shared block's weights are reused across sites
            n = 1 if kind == "shared_attn" else count
            total += n * self.block_params(kind)
        return total

    def _attn_params(self) -> int:
        D, H, KV, hd = (self.d_model, self.num_heads, self.num_kv_heads,
                        self.head_dim)
        return D * (H + 2 * KV) * hd + H * hd * D + \
            ((H + 2 * KV) * hd if self.qkv_bias else 0)

    def block_params(self, kind: str) -> int:
        """Parameters of one block of ``kind`` (the reference's count: its
        dense layers' MLP at ``d_ff`` and no qk-norm scales)."""
        D = self.d_model
        if kind == "dense":
            return self._attn_params() + 3 * D * self.d_ff + 2 * D
        if kind == "moe":
            router = D * self.num_experts
            experts = self.num_experts * 3 * D * self.d_ff
            shared = self.num_shared_experts * 3 * D * self.d_ff
            return self._attn_params() + router + experts + shared + 2 * D
        if kind == "mamba":
            din, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = D * (2 * din + 2 * N + Hs)
            conv = self.ssm_conv_width * (din + 2 * N)
            return in_proj + conv + din * D + 3 * Hs + din + D
        if kind == "shared_attn":
            attn = D * (self.num_heads + 2 * self.num_kv_heads) * \
                self.head_dim + self.num_heads * self.head_dim * D
            return attn + 3 * D * self.d_ff + 2 * D
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Parameters touched per token (moe: the routed top-k and the
        shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        inactive = self.num_experts - self.experts_per_token
        moe_layers = sum(c for k, c in self.block_pattern() if k == "moe")
        return self.param_count() - \
            moe_layers * inactive * 3 * self.d_model * self.d_ff

    def model_flops_per_token(self, seq_len: int, *, training: bool,
                              decode: bool = False) -> float:
        """MODEL_FLOPS per token: 6·N_active (train) / 2·N_active (fwd)
        + attention term. ``decode``: one-token step against a seq_len
        cache (the reference's formula, repro/models/config.py:155)."""
        N = self.active_param_count()
        base = (6 if training else 2) * N
        # attention flops per token: 2 matmuls * 2 flops * window
        H, hd = self.num_heads, self.head_dim
        n_attn = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            n_attn = self.num_layers
        elif self.family == "hybrid":
            n_attn = len(self.shared_attn_layers())
        window = seq_len if decode else seq_len / 2  # causal average
        attn = (3 if training else 1) * n_attn * 4 * H * hd * window
        # ssd flops per token: state update + output, linear in state
        n_ssm = self.num_layers if self.family in ("ssm", "hybrid") else 0
        ssd = (3 if training else 1) * n_ssm * 6 * self.d_inner \
            * self.ssm_state
        return base + attn + ssd
