"""Plain PyTorch SSD chunk scan (port of repro/kernels/ssd/ref.py, which is
repro/models/ssm.py's chunked ``ssd`` unrolled): the CPU path of the
registry, the function the scan's gradient differentiates, and the
reference the CUDA kernel is held against on the card."""
import torch
import torch.nn.functional as F


def _ssd_chunk(u_c, dlog_c, B_c, C_c, state):
    """One SSD chunk (port of repro/models/ssm.py ``_ssd_chunk`` :52).
    u_c: (B, Q, H, P); dlog_c: (B, Q, H); B_c, C_c: (B, Q, N); state:
    (B, H, P, N), all f32.  Returns (y_c, new_state).

    The decay ``exp(A_cs[q] - A_cs[s])`` is taken only where q >= s (the
    reference takes it everywhere and zeroes it above the diagonal, where it
    can overflow): the same values, and a gradient without ``0 * inf``."""
    Q = u_c.shape[1]
    A_cs = torch.cumsum(dlog_c, dim=1)                      # (B, Q, H)
    # intra-chunk: y[q] = sum_{s<=q} (C_q . B_s) exp(A_cs[q]-A_cs[s]) u[s]
    scores = torch.einsum("bqn,bsn->bqs", C_c, B_c)         # (B, Q, Q)
    dec = A_cs[:, :, None, :] - A_cs[:, None, :, :]         # (B, Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u_c.device).tril()
    L = torch.exp(dec.masked_fill(~causal[None, :, :, None], float("-inf")))
    y_intra = torch.einsum("bqs,bqsh,bshp->bqhp", scores, L, u_c)
    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", C_c, torch.exp(A_cs), state)
    # new state: the old one decayed plus the chunk's accumulation
    dec_end = torch.exp(A_cs[:, -1:, :] - A_cs)             # (B, Q, H)
    new_state = torch.einsum("bqh,bqn,bqhp->bhpn", dec_end, B_c, u_c) + \
        torch.exp(A_cs[:, -1])[:, :, None, None] * state
    return y_intra + y_inter, new_state


def ssd_ref(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """u: (B, S, H, P); dlog: (B, S, H); Bm, Cm: (B, S, N) -> y like u.

    Chunks of ``min(chunk, S)`` positions (S is zero-padded to a multiple
    and the padding cut off), computed in f32, y cast back to u's dtype."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    u32, d32, B32, C32 = (t.float() for t in (u, dlog, Bm, Cm))
    if pad:
        u32 = F.pad(u32, (0, 0, 0, 0, 0, pad))
        d32 = F.pad(d32, (0, 0, 0, pad))
        B32 = F.pad(B32, (0, 0, 0, pad))
        C32 = F.pad(C32, (0, 0, 0, pad))
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(0, S + pad, Q):
        y, state = _ssd_chunk(u32[:, i:i + Q], d32[:, i:i + Q],
                              B32[:, i:i + Q], C32[:, i:i + Q], state)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(u.dtype)
