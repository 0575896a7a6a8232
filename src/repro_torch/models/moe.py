"""Mixture-of-experts block: shared experts plus routed top-k experts with
sort-based capacity dispatch (port of repro/models/moe.py:
``moe_params_shape`` :23, ``_route`` :40, ``_slot_tables`` :49,
``_experts_ffn`` :67, the expert-parallel ``_moe_routed_shard_map`` :75
and ``_shard_map_ok`` :146, ``moe_block`` :157, ``_finish_moe`` :191).

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

Expert parallelism (``_moe_routed_expert_parallel``) runs under
``sharding.rules.use_mesh`` when ``cfg.moe_impl`` is not "gspmd" and the
``experts`` axis maps to one mesh dimension of extent n > 1 that divides
the experts, as the reference decides.  Every rank runs the body of the
reference's ``shard_map``: ``x`` is its share of the batch, the same on
every rank of the experts group (so the reference's test that the batch
extent divides the global batch holds by construction), and
``p["experts"]`` holds only its E/n experts, rank r of the group experts
[r E/n, (r + 1) E/n) (``repro_torch.convert.expert_parallel_shard`` cuts
them from a whole tree).  Each rank routes every token against all
experts and builds the whole slot tables, with the same capacity, so the
same assignments are dropped; it runs its own range of slots and combines
their outputs into a (T, D) partial, adding each token's slots in
ascending order as above; one sum over the group of the partials follows.
Where the ``fsdp`` axis has extent above 1, the router and the experts'
d_model rows arrive cut over it, and are gathered first.

The collectives run over gloo through host memory (distributed/reduce.py
``group_reduce``, ``group_all_gather``).  The sum of the partials runs in
f32 and is cast back to the model's dtype: it is not the reference's bf16
``psum``, nor the single-process block's sequential adds, so in bf16 the
two paths agree to a tolerance, in f32 to the rounding of the sum.  The
gradient is the single-process block's, not n times it: the sum passes the
cotangent through unchanged (every rank computes the loss from the same
replicated output, and ``torch.distributed.nn``'s all-reduce would sum the
n equal cotangents); the tokens and the router enter the routed path
through the converse, an identity whose backward sums the partial
gradients over the group; a gathered weight's backward sums over the fsdp
group and keeps this rank's rows.  The groups come from the mesh, never
from a thread's binding: on the card the backward, and with it the
recompute of a checkpointed layer, runs on the autograd engine's thread.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import reduce
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation
from repro_torch.sharding import rules as rules_lib


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


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over ``group`` (f32, cast back).  Backward: the
    cotangent unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return reduce.group_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IntoGroup(torch.autograd.Function):
    """Forward: the identity.  Backward: the cotangent summed over
    ``group`` (f32, cast back)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce.group_reduce(g, ctx.group, "sum"), None


class _GatherOverGroup(torch.autograd.Function):
    """Forward: the group's shards concatenated along ``dim`` (tiled).
    Backward: the cotangent summed over the group, this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce.group_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = reduce.group_reduce(g, ctx.group, "sum")
        size = dist.get_world_size(ctx.group)
        own = total.chunk(size, ctx.dim)[dist.get_rank(ctx.group)]
        return own.contiguous(), None, None


def _expert_parallel_ok(cfg: ModelConfig) -> bool:
    rules = rules_lib.current()
    if rules is None or cfg.moe_impl == "gspmd":
        return False
    n_model = rules_lib.axis_extent("experts")
    return (isinstance(rules.axis("experts"), str) and n_model > 1
            and cfg.num_experts % n_model == 0)


def _moe_routed_expert_parallel(cfg: ModelConfig, p: dict,
                                xt: torch.Tensor, rules) -> torch.Tensor:
    """The routed experts' output (T, D) for this rank's tokens xt (T, D),
    this rank holding its E/n experts (module docstring)."""
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    group = rules.mesh.get_group(rules.axis("experts"))
    n_model = dist.get_world_size(group)
    E_loc = E // n_model
    router, we = p["router"], p["experts"]
    fsdp_ax = rules.axis("fsdp")
    if fsdp_ax is not None and rules_lib.axis_extent("fsdp") > 1:
        fsdp = rules.mesh.get_group(fsdp_ax)
        router = _GatherOverGroup.apply(router, fsdp, 0)
        we = {"w_gate": _GatherOverGroup.apply(we["w_gate"], fsdp, 1),
              "w_up": _GatherOverGroup.apply(we["w_up"], fsdp, 1),
              "w_down": _GatherOverGroup.apply(we["w_down"], fsdp, 2)}
    if we["w_gate"].shape[0] != E_loc:
        raise ValueError(
            f"expert parallelism over {n_model} ranks: each holds {E_loc} "
            f"of the {E} experts, got {we['w_gate'].shape[0]} "
            f"(convert.expert_parallel_shard cuts them)")
    xt = _IntoGroup.apply(xt, group)
    router = _IntoGroup.apply(router, group)

    capacity = int(cfg.capacity_factor * T * k / E) + 1
    gate_w, gate_idx = _route(cfg, router, xt)
    slot_tok, slot_w, token_slots = _slot_tables(E, k, capacity, gate_w,
                                                 gate_idx, T)
    # this rank's range of slots
    n_loc = E_loc * capacity
    lo = dist.get_rank(group) * n_loc
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)])
    buf = xt_pad[slot_tok[lo:lo + n_loc]].reshape(E_loc, capacity, D)
    out_buf = _experts_ffn(cfg, we, buf)
    contrib = out_buf.reshape(n_loc, D) * \
        slot_w[lo:lo + n_loc, None].to(xt.dtype)
    local = token_slots - lo
    local = torch.where((local >= 0) & (local < n_loc), local, n_loc)
    return _SumOverGroup.apply(_combine(contrib, local), group)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    if _expert_parallel_ok(cfg):
        routed = _moe_routed_expert_parallel(cfg, p, xt, rules_lib.current())
        return _finish_moe(cfg, p, xt, routed, B, S, D)
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
