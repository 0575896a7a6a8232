"""Plain PyTorch attention (port of repro/kernels/flash/ref.py
``attention_ref``): the CPU path of the registry, the function the
attention gradient differentiates, and the reference the CUDA kernel is
held against on the card."""
import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, Sk, hd) with Hq % Hkv == 0 ->
    (B, Hq, S, hd) in v's dtype.

    Query head h reads KV head ``h // (Hq // Hkv)``.  As the kernel
    computes it: logits and softmax in f32, the probabilities rounded to
    v's dtype before the f32 product with v (for f32 inputs this is
    ``attention_ref`` exactly).  The causal mask is aligned at the end, as
    the reference's: query i sees keys j <= i + Sk - S."""
    B, Hq, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / hd ** 0.5
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
