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
intra-chunk matrix of every chunk comes from one launch of the WKV
kernel (`kernels.wkv`, differentiable: its backward is a kernel too),
which never holds the (B, H, c, c, N) term the reference builds a chunk
at a time; the intra output, the bonus and each chunk's state
contribution are batched over the chunks, and only the state each chunk
starts from is carried in a loop (one (B, H, N, N) update a chunk).
Decode runs the exact recurrence, one token a call. Rounding to
COMPUTE_DT happens where the reference rounds: each projection's output,
the scan and the decay in float32, `ln_x` in COMPUTE_DT.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models.layers import (COMPUTE_DT, _init, chunk_starts,
                                      init_rmsnorm, rmsnorm)


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
    nc = S // c
    xr, xk, xv, xw, xg = _mix_rkvwg(p, xn, shift_last)
    r = torch.matmul(xr, _w(p, "t_r"))
    k = torch.matmul(xk, _w(p, "t_k"))
    v = torch.matmul(xv, _w(p, "t_v"))
    g = torch.matmul(xg, _w(p, "t_g"))
    logw = _log_decay(p, xw)

    def heads(x):  # (B, H, S, N) float32
        return x.reshape(B, S, H, N).transpose(1, 2).float().contiguous()

    rh, kh, vh, lw = heads(r), heads(k), heads(v), heads(logw)
    lw = lw.reshape(B, H, nc, c, N)
    l = torch.cumsum(lw, 3)  # (B, H, nc, c, N), decreasing in a chunk
    l_prev = l - lw  # l_{t-1}
    # intra-chunk: A[t, i] = sum_n r_tn k_in exp(l_{t-1,n} - l_{i,n}),
    # i < t, every chunk in one launch
    A = wkv_ops.wkv_intra(rh, kh, l_prev.reshape(B, H, S, N),
                          l.reshape(B, H, S, N), c)
    r5, k5, v5 = (t.reshape(B, H, nc, c, N) for t in (rh, kh, vh))
    o = torch.matmul(A, v5)
    del A
    # diagonal bonus: (r_t . u . k_t) v_t
    u = p["bonus_u"][None, :, None, None, :]
    o = o + (r5 * u * k5).sum(-1, keepdim=True) * v5
    # the state each chunk starts from: the only sequential part
    decay = torch.exp(l[:, :, :, -1, :])[..., None]  # (B, H, nc, N, 1)
    kd = k5 * torch.exp(l[:, :, :, -1:, :] - l)
    kv = torch.matmul(kd.transpose(-1, -2), v5)  # (B, H, nc, N, N)
    starts, st = chunk_starts(state.float(), decay, kv)
    # state contribution
    o = o + torch.matmul(r5 * torch.exp(l_prev), starts)
    out = o.reshape(B, H, S, N).transpose(1, 2).reshape(B, S, D)
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

