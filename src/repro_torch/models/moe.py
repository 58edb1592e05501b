"""Mixture-of-Experts FFN with GAIA placement — the port of
`repro.models.moe`, with the reference's dispatch groups (one per
data-axis block of the batch, or one global group under `ep2d`).

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


class _Dispatch(torch.autograd.Function):
    """buf[dest] = xt[src]: the slot buffer (E*C + 1, D) with the dropped
    slots in its last row. The backward sums each token's K slot
    gradients in float32 in top-k rank order and rounds once (the
    gather's own backward would add them with an index_put whose
    duplicates sum in an order of the library's choosing). The last
    row's gradient is zero: the layer never reads that row."""

    @staticmethod
    def forward(ctx, xt, src, dest, slot_dest, n_rows):
        ctx.save_for_backward(slot_dest)
        buf = xt.new_zeros((n_rows, xt.shape[1]))
        buf[dest] = xt[src]
        return buf

    @staticmethod
    def backward(ctx, g_buf):
        slot_dest, = ctx.saved_tensors
        acc = g_buf[slot_dest[:, 0]].float()
        for k in range(1, slot_dest.shape[1]):
            acc = acc + g_buf[slot_dest[:, k]].float()
        return acc.to(g_buf.dtype), None, None, None, None


class _Combine(torch.autograd.Function):
    """out[t] = sum_k w[t, k] * y[slot_dest[t, k]] in float32, rank
    order, rounded once to y's dtype; a dropped slot (slot_dest = E*C)
    reads a zero row. The backward writes each kept slot's gradient
    once (every kept slot belongs to one (token, rank)), so nothing is
    summed in an order of the library's choosing."""

    @staticmethod
    def forward(ctx, y_flat, w, slot_dest):
        y_pad = torch.cat([y_flat, y_flat.new_zeros((1, y_flat.shape[1]))])
        rows = y_pad[slot_dest]  # (T, K, D)
        ctx.save_for_backward(w, slot_dest, rows)
        ctx.n_slots = y_flat.shape[0]
        contrib = w.float()[:, :, None] * rows.float()
        acc = contrib[:, 0]
        for k in range(1, contrib.shape[1]):
            acc = acc + contrib[:, k]
        return acc.to(y_flat.dtype)

    @staticmethod
    def backward(ctx, g_out):
        w, slot_dest, rows = ctx.saved_tensors
        g32 = g_out.float()
        g_w = (g32[:, None, :] * rows.float()).sum(-1).to(w.dtype)
        n = rows.shape[0] * rows.shape[1]
        g_rows = (w.float()[:, :, None] * g32[:, None, :]).to(rows.dtype)
        g_y = rows.new_zeros((ctx.n_slots + 1, rows.shape[2]))
        g_y[slot_dest.reshape(-1)] = g_rows.reshape(n, -1)
        return g_y[:ctx.n_slots], g_w, None


def _dispatch(p, xt, seg_e, top_p, E: int, K: int, C: int, offsets=None):
    """One dispatch group: xt (Tg, D) tokens, seg_e (Tg, K) segment ids,
    top_p (Tg, K) weights, capacity C. `offsets` (E,): the slots each
    segment already holds from earlier tokens of the group on other
    ranks (ep2d). Returns (out (Tg, D), counts by segment (E,),
    dropped)."""
    T, D = xt.shape
    flat_e = seg_e.reshape(T * K).long()
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(K)
    # stable, as the reference's jnp.argsort(..., stable=True): within a
    # segment the slots keep token order, so the same ones are dropped
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = bincount(flat_e, E)  # per segment
    seg_start = (torch.cumsum(counts, 0) - counts).long()
    pos_in_e = torch.arange(T * K, device=xt.device) - seg_start[se]
    if offsets is not None:
        pos_in_e = pos_in_e + offsets.long()[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, E * C)
    # each (token, rank) slot's row in the buffer; E * C when dropped
    slot_dest = torch.empty_like(dest)
    slot_dest[order] = dest
    slot_dest = slot_dest.reshape(T, K)

    buf = _Dispatch.apply(xt, flat_t[order], dest, slot_dest, E * C + 1)
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
    w = torch.where(slot_dest < E * C, top_p, torch.zeros_like(top_p))
    out = _Combine.apply(y_flat, w, slot_dest)
    return out, counts, (~keep).sum()


def moe_fwd(p, x, *, m, router_bias=None, placement=None,
            train: bool = False, px=None, batch_entry=None):
    """x: (B, S, d). Returns (out, metrics) with `expert_counts` (E,),
    `group_expert_counts` (G, E) and `moe_dropped`; with `train` also
    `moe_aux_loss` (the switch-style load-balance loss, differentiable
    in the router). The dispatch and combine are autograd functions
    whose backward passes sum in a fixed order.

    router_bias: (E,) float32 selection-only bias.
    placement: (E,) permutation: expert e is served by segment
      placement[e] of the stored weights.
    px, batch_entry: the dispatch groups, as the reference's: G =
      `px.axis_size(batch_entry)` groups of T / G tokens in batch order,
      each with its own capacity and drops; under `px.ep2d`, when E
      divides the joint axis, one global group. On a distributed mesh x
      is this rank's rows (one group): the counts, the dropped slots and
      the aux loss are this rank's shares, which the train step sums
      over the rows' ranks; under ep2d the capacity positions start
      after the earlier ranks' slots (an all-gather of the (E,)
      counts)."""
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = torch.matmul(xt.float(), p["router"])
    gate = gate_ops.moe_gate(
        logits, K, bias=None if router_bias is None else router_bias.detach(),
        norm_topk=m.norm_topk_prob, prob_mean=train)
    top_p, top_e, expert_counts = gate[:3]
    top_p = top_p.to(COMPUTE_DT)
    seg_e = top_e if placement is None else placement.long()[top_e.long()]

    # ---- sort-based dispatch in groups ------------------------------------
    n_rows = px.axis_size(batch_entry) if px is not None else 1
    live = px is not None and px.distributed and batch_entry is not None
    T_all = T * n_rows if live else T  # the microbatch's tokens
    use_2d = (px is not None and px.ep2d and px.ep_axes is not None
              and E % px.axis_size(px.ep_axes) == 0)
    offsets = None
    if use_2d:
        G, C = 1, max(2 * K, _capacity(T_all, m))
        if live:  # the slots of the ranks holding earlier rows
            mine = bincount(seg_e.reshape(-1).long(), E)
            every = px.row_gather(mine, batch_entry)
            offsets = every[:px.index(batch_entry)].sum(0)
    else:
        G = 1 if live else n_rows
        C = max(2 * K, _capacity(T_all // n_rows, m))
    Tg = T // G
    outs, gcounts, dropped = [], [], []
    for gi in range(G):
        sl = slice(gi * Tg, (gi + 1) * Tg)
        o, c, d = _dispatch(p, xt[sl], seg_e[sl], top_p[sl], E, K, C,
                            offsets)
        outs.append(o)
        gcounts.append(c)
        dropped.append(d)
    out = (outs[0] if G == 1 else torch.cat(outs)).reshape(B, S, D)

    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x)
    gcounts = torch.stack(gcounts)  # (G, E) by segment
    if placement is not None:  # by expert id
        gcounts = gcounts[:, placement.long()]
    metrics = {
        "expert_counts": expert_counts,
        "group_expert_counts": gcounts,
        "moe_dropped": dropped[0] if G == 1 else torch.stack(dropped).sum(),
    }
    if train:
        # switch-style load-balance loss: the token shares are
        # constants, the probability means carry the gradient
        counts = px.row_sum(expert_counts, batch_entry) if live \
            else expert_counts
        frac_tokens = counts.float() / (T_all * K)
        probs = gate[3] if T_all == T else gate[3] * (T / T_all)
        metrics["moe_aux_loss"] = E * torch.sum(frac_tokens * probs)
    return out, metrics
