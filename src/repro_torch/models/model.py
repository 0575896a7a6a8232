"""The LM: embeddings -> block stack -> head, for the dense, ssm and hybrid
families (port of repro/models/model.py: ``param_shapes`` :69,
``_mamba_layer`` :162, ``_hybrid_stack`` :188, ``embed_tokens`` :225,
``forward`` :250, ``project_logits`` :281, ``loss_fn`` :292).

Parameters are a nested dict of tensors in the reference's layout, layer
weights stacked on a leading (L, ...) dim, so blocking and pooling see the
reference's shapes.  The layer loop is a Python loop over slices of the
stacks; with ``cfg.remat`` each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint``.  The
hybrid family (zamba2) has ONE shared attention+MLP block, unstacked,
applied before the mamba mixer of every ``attn_every``-th layer.  With tied
embeddings there is no ``lm_head``: the logits are ``x @ embed.T``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_mlp, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port's model does not run yet:
    the moe, vlm and audio families and the features only they use
    (ROADMAP.md queue 1 item 13)."""
    unsupported = {
        "family": cfg.family not in FAMILIES,
        "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
        "mrope": cfg.mrope,
        "embed_scale": cfg.embed_scale, "num_codebooks": cfg.num_codebooks,
        "embed_inputs": not cfg.embed_inputs,
        "remat_policy": cfg.remat_policy != "full",
        "attn_logits_dtype": cfg.attn_logits_dtype != "float32",
        "dtype": cfg.dtype not in DTYPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} not ported yet: the port runs the dense, ssm "
            f"and hybrid families; moe, vlm, audio and their features wait "
            f"for ROADMAP.md queue 1 item 13")


def _dense_layer_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    return {
        "attn": attn_lib.attn_params_shape(cfg),
        "mlp": {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff),
                "w_down": (cfg.d_ff, D)},
        "norm1": (D,),
        "norm2": (D,),
    }


def _stack(shapes: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes (the reference's tree)."""
    check_supported(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    shapes = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    if cfg.family == "dense":
        shapes["layers"] = _stack(_dense_layer_shapes(cfg), L)
    else:
        shapes["layers"] = _stack({"mixer": ssm_lib.ssm_params_shape(cfg),
                                   "norm": (D,)}, L)
    if cfg.family == "hybrid":
        # one shared transformer block, applied at every site
        shapes["shared_attn"] = _dense_layer_shapes(cfg)
    return shapes


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
                            device=device)
            # in place: zamba2-7b's stacked in_proj is 16.9 GB in f32
            leaves.append(w.mul_(shape[-2] ** -0.5).to(dtype))
    return tree.unflatten(like, leaves)


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_lib.attention_block(cfg, p["attn"], h, positions)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + gated_mlp(cfg, p["mlp"], h)


def _mamba_layer(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + ssm_lib.mamba_block(cfg, p["mixer"], h)


def _hybrid_block(cfg: ModelConfig, shared: dict, p: dict, site: bool,
                  x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One hybrid layer: the shared attention+MLP block at a site, then the
    layer's mamba mixer."""
    if site:
        x = _dense_block(cfg, shared, x, positions)
    return _mamba_layer(cfg, p, x)


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
    sites = cfg.shared_attn_layers()
    for i in range(cfg.num_layers):
        p_i = layer(params["layers"], i)
        if cfg.family == "dense":
            fn, args = _dense_block, (cfg, p_i, x, positions)
        elif cfg.family == "ssm":
            fn, args = _mamba_layer, (cfg, p_i, x)
        else:
            fn, args = _hybrid_block, (cfg, params["shared_attn"], p_i,
                                       i in sites, x, positions)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(fn, *args,
                                                  use_reentrant=False)
        else:
            x = fn(*args)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return project_logits(cfg, params, x)


def project_logits(cfg: ModelConfig, params: dict,
                   x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T)
    return torch.matmul(x, params["lm_head"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy in f32."""
    logits = forward(cfg, params, batch).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(logz - gold)
