"""Mixture-of-experts block: shared experts plus routed top-k experts with
sort-based capacity dispatch (port of repro/models/moe.py, its
single-device path: ``moe_params_shape`` :23, ``_route`` :40,
``_slot_tables`` :49, ``_experts_ffn`` :67, ``moe_block`` :157,
``_finish_moe`` :191).

Each token picks its top ``experts_per_token`` experts by router
probability; every expert takes at most ``capacity = int(capacity_factor *
T * k / E) + 1`` tokens, in token order, and the rest are dropped (their
slot is the overflow slot ``E * capacity``, written and discarded).
Dispatch gathers the (E * capacity, D) expert inputs from the token table
padded with a zero row; the experts are three batched products over (E,
capacity, D); the reference computes all of it in ``jnp`` outside any
Pallas kernel, so no kernel is ported here.

Where the port keeps the reference's choices:
  * ties in the top k keep the lower expert first, as ``jax.lax.top_k``:
    a stable descending sort, then the first k (``torch.topk`` promises no
    order among ties);
  * the sort of assignments by expert is stable, as ``jnp.argsort``, so a
    token's place in its expert's queue, and so which tokens are dropped,
    is the reference's;
  * the capacity is the same Python int.

The combine differs in form, not in order.  The reference scatter-adds
each slot's weighted output into its token (``.at[slot_tok].add``); on the
card ``index_add_`` would sum a token's contributions with atomics, in an
order that varies from run to run.  Here each token gathers its k slots,
sorted ascending (dropped ones read a zero row), and adds them one after
another in the model's dtype, each sum rounded: the order in which XLA's
scatter visits them (slots ascending), so the forward repeats bit for bit
on the card and on the CPU.  The CPU path takes the same order; in bf16
``_combine`` equals the jitted reference's scatter-add bit for bit, and
the whole block is within 2^-8 of its largest output of the reference's
(tests/test_torch_moe.py: the router's f32 logits sum in another order).

The reference's ``shard_map`` path (:75-143, taken only under a mesh with
more than one ``experts`` shard, ``_shard_map_ok`` :146) waits for
ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation


def moe_params_shape(cfg: ModelConfig) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {
        "router": (D, E),
        "experts": {"w_gate": (E, D, F), "w_up": (E, D, F),
                    "w_down": (E, F, D)},
    }
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * cfg.d_ff
        shapes["shared"] = {"w_gate": (D, Fs), "w_up": (D, Fs),
                            "w_down": (Fs, D)}
    return shapes


def _route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Top-k routing tables of xt (T, D): (gate_w (T, k) f32 normalized,
    gate_idx (T, k) long), ties to the lower expert.  The logits are the
    f32 products of the inputs, never rounded to a bf16 x's dtype: the
    reference's jitted ``einsum(...).astype(float32)`` computes the bf16
    product in f32 and drops the round trip through bf16."""
    logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gate_w, gate_idx = top[:, :k], idx[:, :k]
    gate_w = gate_w / (torch.sum(gate_w, dim=-1, keepdim=True) + 1e-9)
    return gate_w, gate_idx


def _slot_tables(E: int, k: int, capacity: int, gate_w: torch.Tensor,
                 gate_idx: torch.Tensor, T: int):
    """Slot-indexed routing tables: (slot_tok (E * capacity,) long, T for
    an empty slot; slot_w (E * capacity,) f32; token_slots (T, k) long,
    each token's slots ascending, ``E * capacity`` for a dropped
    assignment)."""
    dev = gate_idx.device
    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sw = flat_expert[order], flat_token[order], flat_w[order]
    counts = torch.bincount(flat_expert, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e, E * capacity)
    slot_tok = torch.full((E * capacity + 1,), T, dtype=torch.long,
                          device=dev)
    slot_tok[slot] = stok
    slot_w = torch.zeros(E * capacity + 1, dtype=torch.float32,
                         device=dev).index_put(
        (slot,), torch.where(keep, sw, torch.zeros_like(sw)))
    flat_slot = torch.empty_like(slot)
    flat_slot[order] = slot
    token_slots = torch.sort(flat_slot.reshape(T, k), dim=-1).values
    return slot_tok[:-1], slot_w[:-1], token_slots


def _experts_ffn(cfg: ModelConfig, we: dict,
                 buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' gated MLPs on buf (E, capacity, D)."""
    h = activation(cfg)(torch.matmul(buf, we["w_gate"])) * \
        torch.matmul(buf, we["w_up"])
    return torch.matmul(h, we["w_down"])


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    gate_w, gate_idx = _route(cfg, p["router"], xt)
    capacity = int(cfg.capacity_factor * T * k / E) + 1
    slot_tok, slot_w, token_slots = _slot_tables(E, k, capacity, gate_w,
                                                 gate_idx, T)

    # dispatch: one (E * capacity, D) gather from the padded token table
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)])
    buf = xt_pad[slot_tok].reshape(E, capacity, D)
    out_buf = _experts_ffn(cfg, p["experts"], buf)

    contrib = out_buf.reshape(E * capacity, D) * slot_w[:, None].to(x.dtype)
    return _finish_moe(cfg, p, xt, _combine(contrib, token_slots), B, S, D)


def _combine(contrib: torch.Tensor, token_slots: torch.Tensor
             ) -> torch.Tensor:
    """Each token's k slot outputs of contrib (E * capacity, D), slots
    ascending as ``token_slots`` (T, k) lists them, added one at a time in
    contrib's dtype (the overflow slot reads a zero row): (T, D)."""
    picked = torch.cat([contrib, contrib.new_zeros(1, contrib.shape[1])]
                       )[token_slots]
    routed = picked[:, 0]
    for j in range(1, token_slots.shape[1]):
        routed = routed + picked[:, j]
    return routed


def _finish_moe(cfg: ModelConfig, p: dict, xt: torch.Tensor,
                routed: torch.Tensor, B: int, S: int, D: int
                ) -> torch.Tensor:
    """Add the shared experts' gated MLP (if any) to the routed output."""
    out = routed
    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = activation(cfg)(torch.matmul(xt, sh["w_gate"])) * \
            torch.matmul(xt, sh["w_up"])
        out = out + torch.matmul(hs, sh["w_down"])
    return out.reshape(B, S, D)
