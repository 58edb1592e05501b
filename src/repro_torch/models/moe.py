"""Mixture-of-Experts FFN with GAIA placement — the port of
`repro.models.moe` for one device (one dispatch group).

Dispatch is sort-based ("dropping" style): token/expert slots are ranked
within their expert segment by a stable sort and slots beyond the static
capacity are dropped, exactly as the reference ranks them. Routing goes
through the fused gate kernel (`kernels/moe_gate`), which replaces the
reference's softmax -> top_k -> take_along_axis -> renormalisation and
its bincount of the picks.

GAIA placement: ``placement[e]`` is the buffer segment serving expert e.
Expert weights are stored in segment order, so the layer only remaps the
routing ids; the physical weight move happens once per migration
(`core/gaia_moe.py`).
"""
from __future__ import annotations

import torch

from repro_torch.core.balance import bincount
from repro_torch.kernels.moe_gate import ops as gate_ops
from repro_torch.models.layers import COMPUTE_DT, _init, mlp_fwd, silu_mul


def init_moe(gen, d: int, cfg_moe):
    m = cfg_moe
    p = {
        "router": _init(gen, (d, m.num_experts), scale=0.02,
                        dtype=torch.float32),
        "w_gate": _init(gen, (m.num_experts, d, m.d_expert)),
        "w_up": _init(gen, (m.num_experts, d, m.d_expert)),
        "w_down": _init(gen, (m.num_experts, m.d_expert, d)),
    }
    if m.num_shared_experts:
        f = m.d_shared * m.num_shared_experts
        p["shared"] = {"w_gate": _init(gen, (d, f)),
                       "w_up": _init(gen, (d, f)),
                       "w_down": _init(gen, (f, d))}
    return p


def _capacity(tokens: int, m) -> int:
    c = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_fwd(p, x, *, m, router_bias=None, placement=None):
    """x: (B, S, d). Returns (out, metrics) with `expert_counts` (E,),
    `group_expert_counts` (1, E) and `moe_dropped`, as the reference
    with one dispatch group. (The training slice adds `moe_aux_loss`.)

    router_bias: (E,) float32 selection-only bias.
    placement: (E,) permutation: expert e is served by segment
      placement[e] of the stored weights."""
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = torch.matmul(xt.float(), p["router"])
    top_p, top_e, expert_counts = gate_ops.moe_gate(
        logits, K, bias=router_bias, norm_topk=m.norm_topk_prob)
    top_p = top_p.to(COMPUTE_DT)
    seg_e = top_e if placement is None else placement.long()[top_e.long()]

    # ---- sort-based dispatch, one group --------------------------------
    C = max(2 * K, _capacity(T, m))
    flat_e = seg_e.reshape(T * K).long()
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    # stable, as the reference's jnp.argsort(..., stable=True): within a
    # segment the slots keep token order, so the same ones are dropped
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = bincount(flat_e, E)  # per segment
    seg_start = (torch.cumsum(counts, 0) - counts).long()
    pos_in_e = torch.arange(T * K, device=x.device) - seg_start[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, E * C)

    buf = xt.new_zeros((E * C + 1, D))
    buf[dest] = xt[flat_t[order]]
    h = buf[:E * C].reshape(E, C, D)

    # ---- expert FFN (SwiGLU), batched over all E segments ---------------
    g = torch.bmm(h, p["w_gate"].to(COMPUTE_DT))
    u = torch.bmm(h, p["w_up"].to(COMPUTE_DT))
    y = torch.bmm(silu_mul(g, u), p["w_down"].to(COMPUTE_DT))
    y_flat = y.reshape(E * C, D)

    # ---- combine ----------------------------------------------------------
    # The reference scatter-adds the K weighted contributions in bf16 in
    # segment order; index_add_ on CUDA would add them with atomics in
    # an order that changes from run to run and with the placement. Each
    # token's K contributions are instead summed in float32 in top-k
    # rank order and rounded once: the card's run is deterministic and
    # the placement cannot change a token's output.
    slot_dest = torch.empty_like(dest)
    slot_dest[order] = dest
    slot_dest = slot_dest.reshape(T, K)
    slot_keep = slot_dest < E * C
    safe = slot_dest.clamp(max=E * C - 1)
    w = torch.where(slot_keep, top_p.float(), 0.0)
    contrib = w[:, :, None] * y_flat[safe].float()  # (T, K, D)
    acc = contrib[:, 0]
    for k in range(1, K):
        acc = acc + contrib[:, k]
    out = acc.to(COMPUTE_DT).reshape(B, S, D)

    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x)
    gcounts = counts if placement is None else counts[placement.long()]
    metrics = {
        "expert_counts": expert_counts,
        "group_expert_counts": gcounts[None, :],
        "moe_dropped": (~keep).sum(),
    }
    return out, metrics
