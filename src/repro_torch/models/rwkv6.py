"""RWKV-6 "Finch" — attention-free time mix with data-dependent decay
[arXiv:2404.05892]: the port of `repro.models.rwkv6`.

Recurrence (per head, state S in R^{N x N}):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Chunked form (chunk c): with l_t = cumsum(log w) inside the chunk,
    o_t  = (r_t . exp(l_{t-1})) @ S_0
         + sum_{i<t} [sum_n r_tn k_in exp(l_{t-1,n} - l_{i,n})] v_i
         + (r_t . u . k_t) v_t
    S_c  = diag(exp(l_c)) S_0 + sum_i (k_i . exp(l_c - l_i))^T v_i
Every exponent that is kept is <= 0, so the chunked form is stable. The
prefill scans the chunks one at a time, as the reference's `lax.scan`
does, so only one chunk's (B, H, c, c, N) intra-chunk term exists at a
time (2.15 GB in float32 at rwkv6-1.6b's 16 x 512 prefill). Decode runs
the exact recurrence, one token a call. Rounding to COMPUTE_DT happens
where the reference rounds: each projection's output, the scan and the
decay in float32, `ln_x` in COMPUTE_DT.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DT, _init, init_rmsnorm, rmsnorm


def init_rwkv_block(gen, d: int, cfg):
    r = cfg.rwkv
    H, N = cfg.n_heads, r.head_dim
    dev = gen.device
    return {
        "ln_attn": init_rmsnorm(d, dev),
        "ln_ffn": init_rmsnorm(d, dev),
        # token-shift data-dependent mix (lora): 5 targets r,k,v,w,g
        "mix_base": torch.zeros((5, d), dtype=COMPUTE_DT, device=dev),
        "mix_lora_a": _init(gen, (d, 5 * r.mix_lora)),
        "mix_lora_b": _init(gen, (5, r.mix_lora, d), scale=0.01),
        # projections
        "t_r": _init(gen, (d, d)),
        "t_k": _init(gen, (d, d)),
        "t_v": _init(gen, (d, d)),
        "t_g": _init(gen, (d, d)),
        "t_o": _init(gen, (d, d)),
        # data-dependent decay lora
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "decay_a": _init(gen, (d, r.decay_lora)),
        "decay_b": _init(gen, (r.decay_lora, d), scale=0.01),
        "bonus_u": torch.zeros((H, N), dtype=torch.float32, device=dev),
        "ln_x": init_rmsnorm(d, dev),
        # channel mix
        "ck": _init(gen, (d, cfg.d_ff)),
        "cv": _init(gen, (cfg.d_ff, d)),
        "cr": _init(gen, (d, d)),
    }


def _w(p, name):
    return p[name].to(COMPUTE_DT)


def _time_shift(x, last):
    """Shift right by one along S; position 0 takes `last` (B, d)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], 1)


def _mix_rkvwg(p, xn, last):
    """Data-dependent token-shift interpolation -> the r, k, v, w, g
    inputs, each (B, S, d)."""
    xs = _time_shift(xn, last)
    delta = xs - xn
    lora = torch.tanh(torch.matmul(xn, _w(p, "mix_lora_a")))
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    mixes = _w(p, "mix_base") + torch.einsum(
        "bsir,ird->bsid", lora, _w(p, "mix_lora_b"))
    # x_i = xn + delta * mix_i   for i in r,k,v,w,g
    mixed = xn[:, :, None, :] + delta[:, :, None, :] * mixes
    return mixed.unbind(2)


def _log_decay(p, xw):
    """log w in (-inf, 0), float32: -exp(w_base + lora)."""
    wl = torch.matmul(torch.tanh(torch.matmul(xw, _w(p, "decay_a"))),
                      _w(p, "decay_b"))
    return -torch.exp(p["w_base"] + wl.float())


def _gate_out(p, o, g):
    """ln_x of the heads' output (B, S, d) in COMPUTE_DT, gated by
    silu(g), through t_o."""
    out = rmsnorm(p["ln_x"], o.to(COMPUTE_DT))
    out = out * F.silu(g.float()).to(COMPUTE_DT)
    return torch.matmul(out, _w(p, "t_o"))


def _chunk_step(S0, rc, kc, vc, lwc, u):
    """One chunk of the scan. S0: (B, H, N, N) float32; rc, kc, vc, lwc:
    (B, H, c, N) float32. Returns (S1, o (B, H, c, N))."""
    c = rc.shape[2]
    l = torch.cumsum(lwc, 2)  # (B, H, c, N), decreasing
    l_prev = l - lwc  # l_{t-1}
    # intra-chunk: A[t, i] = sum_n r_tn k_in exp(l_{t-1,n} - l_{i,n}),
    # i < t. The exponent of an entry i >= t is positive and may be inf:
    # it is selected away (never multiplied by a zero mask: inf * 0 = NaN)
    tri = torch.ones((c, c), dtype=torch.bool, device=rc.device).tril(-1)
    decay = torch.where(
        tri[:, :, None],
        torch.exp(l_prev[:, :, :, None, :] - l[:, :, None, :, :]), 0.0)
    rk = decay * rc[:, :, :, None, :]
    del decay  # at most two (B, H, c, c, N) tensors at once
    A = (rk * kc[:, :, None, :, :]).sum(-1)
    del rk
    o = torch.matmul(A, vc)
    # diagonal bonus: (r_t . u . k_t) v_t
    o = o + (rc * u * kc).sum(-1, keepdim=True) * vc
    # state contribution
    o = o + torch.matmul(rc * torch.exp(l_prev), S0)
    # state update
    kd = kc * torch.exp(l[:, :, -1:, :] - l)
    S1 = torch.exp(l[:, :, -1, :])[..., None] * S0 + torch.matmul(
        kd.transpose(-1, -2), vc)
    return S1, o


def rwkv_time_mix(p, xn, state, shift_last, *, cfg):
    """Chunked RWKV6 time mix.

    xn: (B, S, d) normed input; state: (B, H, N, N); shift_last: (B, d).
    S must be a multiple of the chunk or at most one chunk (the
    reference asserts it). Returns (out, new_state, new_shift_last)."""
    B, S, D = xn.shape
    H, N = cfg.n_heads, cfg.rwkv.head_dim
    c = min(cfg.rwkv.chunk, S)
    if S % c:
        raise AssertionError((S, c))
    xr, xk, xv, xw, xg = _mix_rkvwg(p, xn, shift_last)
    r = torch.matmul(xr, _w(p, "t_r"))
    k = torch.matmul(xk, _w(p, "t_k"))
    v = torch.matmul(xv, _w(p, "t_v"))
    g = torch.matmul(xg, _w(p, "t_g"))
    logw = _log_decay(p, xw)

    def heads(x):
        return x.reshape(B, S, H, N).transpose(1, 2).float()  # (B,H,S,N)

    rh, kh, vh, lw = heads(r), heads(k), heads(v), heads(logw)
    u = p["bonus_u"][None, :, None, :]
    st = state.float()
    outs = []
    for i in range(0, S, c):
        st, o = _chunk_step(st, rh[:, :, i:i + c], kh[:, :, i:i + c],
                            vh[:, :, i:i + c], lw[:, :, i:i + c], u)
        outs.append(o)
    out = torch.cat(outs, 2).transpose(1, 2).reshape(B, S, D)
    return _gate_out(p, out, g), st, xn[:, -1, :]


def rwkv_channel_mix(p, xn, shift_last):
    """Returns (out, new_shift_last)."""
    xs = _time_shift(xn, shift_last)
    # rwkv6 channel mix uses a fixed 0.5 shift-mix, as the reference
    xk = 0.5 * (xn + xs)
    k = torch.matmul(xk, _w(p, "ck"))
    k = torch.square(torch.relu(k.float())).to(COMPUTE_DT)
    kv = torch.matmul(k, _w(p, "cv"))
    r = torch.sigmoid(torch.matmul(xk, _w(p, "cr")).float()).to(COMPUTE_DT)
    return r * kv, xn[:, -1, :]


def rwkv_block_fwd(p, x, carry, *, cfg):
    """carry: dict(state (B, H, N, N), shift_a (B, d), shift_f (B, d)).
    Returns (x, new carry)."""
    xn = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    y, state, sa = rwkv_time_mix(p, xn, carry["state"], carry["shift_a"],
                                 cfg=cfg)
    x = x + y
    xf = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
    y2, sf = rwkv_channel_mix(p, xf, carry["shift_f"])
    return x + y2, {"state": state, "shift_a": sa, "shift_f": sf}


def rwkv_decode_step(p, x, carry, *, cfg):
    """Single-token recurrent step (S = 1): the exact recurrence,
    O(N^2) a head. Returns (x, new carry)."""
    B = x.shape[0]
    H, N = cfg.n_heads, cfg.rwkv.head_dim
    xn = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    xr, xk, xv, xw, xg = _mix_rkvwg(p, xn, carry["shift_a"])
    r = torch.matmul(xr, _w(p, "t_r")).reshape(B, H, N).float()
    k = torch.matmul(xk, _w(p, "t_k")).reshape(B, H, N).float()
    v = torch.matmul(xv, _w(p, "t_v")).reshape(B, H, N).float()
    g = torch.matmul(xg, _w(p, "t_g"))
    w = torch.exp(_log_decay(p, xw)).reshape(B, H, N)
    S0 = carry["state"].float()
    kv = k[..., :, None] * v[..., None, :]  # (B, H, N, N)
    o = torch.matmul(r[:, :, None, :],
                     S0 + p["bonus_u"][None, :, :, None] * kv)[:, :, 0]
    S1 = w[..., :, None] * S0 + kv
    x = x + _gate_out(p, o.reshape(B, 1, H * N), g)
    xf = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
    y2, sf = rwkv_channel_mix(p, xf, carry["shift_f"])
    return x + y2, {"state": S1, "shift_a": xn[:, -1, :], "shift_f": sf}

