"""The dense LM: embeddings -> layer stack -> head (port of the dense family
of repro/models/model.py: ``embed_tokens`` :225, ``forward`` :250,
``project_logits`` :281, ``loss_fn`` :292).

Parameters are a nested dict of tensors in the reference's layout, layer
weights stacked on a leading (L, ...) dim, so blocking and pooling see the
reference's shapes.  The layer loop is a Python loop over slices of the
stacks; with ``cfg.remat`` each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_mlp, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port's model does not run yet
    (ROADMAP.md queue 1 item 13 ports the other families)."""
    unsupported = {
        "family": cfg.family != "dense",
        "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
        "mrope": cfg.mrope, "tie_embeddings": cfg.tie_embeddings,
        "embed_scale": cfg.embed_scale, "num_codebooks": cfg.num_codebooks,
        "embed_inputs": not cfg.embed_inputs,
        "remat_policy": cfg.remat_policy != "full",
        "attn_logits_dtype": cfg.attn_logits_dtype != "float32",
        "dtype": cfg.dtype not in DTYPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} not ported yet (ROADMAP.md queue 1 item 13)")


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes (the reference's tree)."""
    check_supported(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    layer = {
        "attn": attn_lib.attn_params_shape(cfg),
        "mlp": {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff),
                "w_down": (cfg.d_ff, D)},
        "norm1": (D,),
        "norm2": (D,),
    }
    stacked = {k: ({kk: (L,) + s for kk, s in v.items()}
                   if isinstance(v, dict) else (L,) + v)
               for k, v in layer.items()}
    return {"embed": (V, D), "lm_head": (D, V), "final_norm": (D,),
            "layers": stacked}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> dict:
    """Random parameters from ``generator``, by the reference's rule:
    vectors zero (norm scales add 1), matrices normal * fan_in^-0.5."""
    like = param_shapes(cfg)
    dtype = DTYPES[cfg.dtype]
    leaves = []
    for shape in tree.flatten(like):
        if len(shape) == 1:
            leaves.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * shape[-2] ** -0.5
            leaves.append(w.to(dtype))
    return tree.unflatten(like, leaves)


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_lib.attention_block(cfg, p["attn"], h, positions)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + gated_mlp(cfg, p["mlp"], h)


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters out of the stacked (L, ...) layer tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def embed_tokens(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Embeddings (B, S, D) of ``batch["tokens"]`` (B, S), in the model's
    dtype."""
    return params["embed"][batch["tokens"]].to(DTYPES[cfg.dtype])


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Logits (B, S, V) for ``batch["tokens"]`` (B, S)."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.num_layers):
        p_i = layer(params["layers"], i)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _dense_block, cfg, p_i, x, positions, use_reentrant=False)
        else:
            x = _dense_block(cfg, p_i, x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return project_logits(cfg, params, x)


def project_logits(cfg: ModelConfig, params: dict,
                   x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["lm_head"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy in f32."""
    logits = forward(cfg, params, batch).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(logz - gold)
