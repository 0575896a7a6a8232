"""The LM: embeddings -> block stack -> head, for every family of the
reference (port of repro/models/model.py: ``param_shapes`` :69,
``param_struct`` :113, ``_moe_block`` :154, ``_mamba_layer`` :162,
``_hybrid_stack`` :188, ``embed_tokens`` :225, ``_positions`` :239,
``forward`` :250, ``project_logits`` :281, ``loss_fn`` :292; the loss
``mask`` :298-304, which no caller sets, is not ported).

Parameters are a nested dict of tensors in the reference's layout, layer
weights stacked on a leading (L, ...) dim, so blocking and pooling see the
reference's shapes.  The layer loop is a Python loop over slices of the
stacks; with ``cfg.remat`` each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint``.  The
hybrid family (zamba2) has ONE shared attention+MLP block, unstacked,
applied before the mamba mixer of every ``attn_every``-th layer.  With tied
embeddings there is no ``lm_head``: the logits are ``x @ embed.T``.  The
moe family (deepseek, kimi) stacks its first ``first_dense_layers`` dense
layers (MLP width ``dense_ff``) as ``dense_layers`` and the rest, each with
an moe sublayer in place of the MLP (models/moe.py), as ``moe_layers``.
The vlm (qwen2-vl) and audio (musicgen) families run dense stacks: the vlm
takes precomputed embeddings ``batch["embeds"]`` (no ``embed`` leaf; an
``lm_head`` even when tied) and M-RoPE positions (3, B, S); the audio
family has K codebooks, ``embed`` (K, V, D) and ``lm_head`` (K, D, V),
tokens and labels (B, S, K) and logits (B, S, K, V).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_mlp, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the families whose layers are dense attention + MLP blocks, and those
# whose every layer attends (one k/v cache a layer)
DENSE_STACKS = ("dense", "vlm", "audio")
ATTENTION_STACKS = DENSE_STACKS + ("moe",)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration values the port's model does not run: an
    unknown family or dtype, and the reference's ``remat_policy="dots"``
    and ``attn_logits_dtype`` other than f32, which no config or caller in
    either package sets."""
    unsupported = {
        "family": cfg.family not in FAMILIES,
        "remat_policy": cfg.remat_policy != "full",
        "attn_logits_dtype": cfg.attn_logits_dtype != "float32",
        "dtype": cfg.dtype not in DTYPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} not ported: the port runs the "
            f"{', '.join(FAMILIES)} families with full remat and f32 "
            f"attention logits")


def _dense_layer_shapes(cfg: ModelConfig, d_ff: int = 0) -> dict:
    D, d_ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "attn": attn_lib.attn_params_shape(cfg),
        "mlp": {"w_gate": (D, d_ff), "w_up": (D, d_ff),
                "w_down": (d_ff, D)},
        "norm1": (D,),
        "norm2": (D,),
    }


def _moe_layer_shapes(cfg: ModelConfig) -> dict:
    return {
        "attn": attn_lib.attn_params_shape(cfg),
        "moe": moe_lib.moe_params_shape(cfg),
        "norm1": (cfg.d_model,),
        "norm2": (cfg.d_model,),
    }


def _stack(shapes: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes (the reference's tree)."""
    check_supported(cfg)
    D, V, L, K = cfg.d_model, cfg.vocab_size, cfg.num_layers, \
        cfg.num_codebooks
    shapes = {"final_norm": (D,)}
    if cfg.embed_inputs:
        shapes["embed"] = (K, V, D) if K else (V, D)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (K, D, V) if K else (D, V)
    elif not cfg.embed_inputs:      # tied, but no embed leaf to tie to
        shapes["lm_head"] = (D, V)
    if cfg.family in DENSE_STACKS:
        shapes["layers"] = _stack(_dense_layer_shapes(cfg), L)
    elif cfg.family == "moe":
        fd = cfg.first_dense_layers
        if fd:
            shapes["dense_layers"] = _stack(
                _dense_layer_shapes(cfg, cfg.dense_ff), fd)
        shapes["moe_layers"] = _stack(_moe_layer_shapes(cfg), L - fd)
    else:
        shapes["layers"] = _stack({"mixer": ssm_lib.ssm_params_shape(cfg),
                                   "norm": (D,)}, L)
    if cfg.family == "hybrid":
        # one shared transformer block, applied at every site
        shapes["shared_attn"] = _dense_layer_shapes(cfg)
    return shapes


def param_struct(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device (shapes and the model's
    dtype, no storage): the dry run's input, the reference's
    ``jax.ShapeDtypeStruct`` tree."""
    like = param_shapes(cfg)
    dtype = DTYPES[cfg.dtype]
    return tree.unflatten(like, [torch.empty(s, dtype=dtype, device="meta")
                                 for s in tree.flatten(like)])


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> dict:
    """Random parameters from ``generator``, by the reference's rule:
    vectors zero (norm scales add 1), matrices normal * fan_in^-0.5.  A
    4-D leaf (only the moe family's stacked experts have one) is drawn one
    layer at a time, so no f32 copy of the whole leaf is ever held:
    deepseek-moe-16b's (27, 64, 2048, 1408) would take 19.9 GB in f32."""
    like = param_shapes(cfg)
    dtype = DTYPES[cfg.dtype]
    leaves = []
    for shape in tree.flatten(like):
        if len(shape) == 1:
            leaves.append(torch.zeros(shape, dtype=dtype, device=device))
        elif len(shape) == 4:
            w = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                w[i] = torch.randn(shape[1:], generator=generator,
                                   dtype=torch.float32, device=device
                                   ).mul_(shape[-2] ** -0.5)
            leaves.append(w)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            # in place: zamba2-7b's stacked in_proj is 16.9 GB in f32
            leaves.append(w.mul_(shape[-2] ** -0.5).to(dtype))
    return tree.unflatten(like, leaves)


def mlp_sublayer(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """A layer's second sublayer: its moe block if it has one, else its
    gated MLP."""
    if "moe" in p:
        return moe_lib.moe_block(cfg, p["moe"], h)
    return gated_mlp(cfg, p["mlp"], h)


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """A dense or moe layer (by its parameters)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_lib.attention_block(cfg, p["attn"], h, positions)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_sublayer(cfg, p, h)


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
    """Embeddings (B, S, D) in the model's dtype: of ``batch["tokens"]``
    (B, S); with ``num_codebooks`` K, of tokens (B, S, K), the sum of the K
    tables' rows in order, in the parameters' dtype; without
    ``embed_inputs``, ``batch["embeds"]`` (B, S, D) (the modality
    frontend's stub) cast.  With ``embed_scale`` (gemma) times
    sqrt(d_model), the scalar rounded to the dtype first as the
    reference's ``jnp.asarray`` does."""
    dtype = DTYPES[cfg.dtype]
    if not cfg.embed_inputs:
        x = batch["embeds"].to(dtype)
    elif cfg.num_codebooks:
        toks, emb = batch["tokens"], params["embed"]
        x = sum(emb[i][toks[..., i]] for i in range(cfg.num_codebooks))
        x = x.to(dtype)
    else:
        x = params["embed"][batch["tokens"]].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype,
                             device=x.device)
    return x


def stacks(params: dict) -> list:
    """The stacked layer trees in order: the moe family's ``dense_layers``
    (if any) then ``moe_layers``, or ``layers``."""
    return [params[k] for k in ("dense_layers", "moe_layers", "layers")
            if k in params]


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int,
               device) -> torch.Tensor:
    """``batch["positions"]`` when the batch has them, else 0..S-1 for
    every row: (B, S), or (3, B, S) with ``mrope``, all three streams
    alike (reference ``_positions`` :239-246)."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(S, device=device)[None].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.mrope else pos


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Logits (B, S, V), or (B, S, K, V) with K codebooks, for
    ``batch["tokens"]`` (or ``batch["embeds"]``) and, if given,
    ``batch["positions"]``."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, batch)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    sites = cfg.shared_attn_layers()
    for stacked in stacks(params):
        for i in range(tree.flatten(stacked)[0].shape[0]):
            p_i = layer(stacked, i)
            if cfg.family in ATTENTION_STACKS:
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
    if cfg.num_codebooks:           # (K, D, V) head: (B, S, K, V)
        return torch.einsum("bsd,kdv->bskv", x, params["lm_head"])
    if cfg.tie_embeddings and cfg.embed_inputs:
        return torch.matmul(x, params["embed"].T)
    return torch.matmul(x, params["lm_head"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy in f32, over every label (with K
    codebooks over B, S and K)."""
    logits = forward(cfg, params, batch).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(logz - gold)
