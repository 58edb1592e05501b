"""Plain PyTorch version of the fused MoE gate.

The same function as the CUDA kernel (`csrc/moe_gate.cu`) and the Pallas
TPU kernel it replaces (`repro.kernels.moe_gate.moe_gate`): softmax as
exp(x - max) / sum, selection on probs + bias, k argmax sweeps that
break ties to the lower index, the unbiased probabilities gathered and
optionally renormalised, and the int32 histogram of the picks. The CPU
path runs it, the tests hold the kernel to it, and `chip_smoke.py`
compares the kernel with it on the card; `moe_gate_grads_plain` is the
backward kernel's twin.
"""
from __future__ import annotations

import torch


def moe_gate_plain(logits, k: int, bias=None, norm_topk: bool = True,
                   prob_mean: bool = False):
    """logits: (T, E) float32 or bfloat16. Returns (top_p (T, k) float32,
    top_e (T, k) int32, counts (E,) int32), and with `prob_mean` also
    the (E,) float32 mean of the probabilities over the rows. top_p and
    the mean are differentiable by autograd (the bias selects only)."""
    T, E = logits.shape
    x = logits.float()
    ex = torch.exp(x - x.max(-1, keepdim=True).values)
    probs = ex / ex.sum(-1, keepdim=True)
    remaining = probs if bias is None else probs + bias.float()[None, :]
    remaining = remaining.clone()
    ps, es = [], []
    for _ in range(k):
        idx = remaining.argmax(-1, keepdim=True)  # first index on ties
        ps.append(probs.gather(1, idx))
        es.append(idx)
        remaining.scatter_(1, idx, -torch.inf)
    top_p = torch.cat(ps, 1)
    top_e = torch.cat(es, 1).to(torch.int32)
    if norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = torch.zeros(E, dtype=torch.int32, device=logits.device)
    counts.index_add_(0, top_e.reshape(-1).long(),
                      torch.ones(T * k, dtype=torch.int32,
                                 device=logits.device))
    if prob_mean:
        return top_p, top_e, counts, probs.mean(0)
    return top_p, top_e, counts


def moe_gate_grads_plain(logits, k: int, bias, norm_topk: bool, g_top_p,
                         g_prob_mean=None):
    """d logits by autograd through `moe_gate_plain` for the output
    gradients g_top_p (T, k) and g_prob_mean (E,) (None: zero): the
    plain twin of the backward kernel, in float32."""
    with torch.enable_grad():
        x = logits.detach().float().requires_grad_()
        out = moe_gate_plain(x, k, bias, norm_topk, prob_mean=True)
        outs, grads = [out[0]], [g_top_p]
        if g_prob_mean is not None:
            outs.append(out[3])
            grads.append(g_prob_mean)
        return torch.autograd.grad(outs, x, grads)[0]
