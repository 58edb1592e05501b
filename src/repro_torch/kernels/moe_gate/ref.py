"""Plain PyTorch version of the fused MoE gate.

The same function as the CUDA kernel (`csrc/moe_gate.cu`) and the Pallas
TPU kernel it replaces (`repro.kernels.moe_gate.moe_gate`): softmax as
exp(x - max) / sum, selection on probs + bias, k argmax sweeps that
break ties to the lower index, the unbiased probabilities gathered and
optionally renormalised, and the int32 histogram of the picks. The CPU
path runs it, the tests hold the kernel to it, and `chip_smoke.py`
compares the kernel with it on the card.
"""
from __future__ import annotations

import torch


def moe_gate_plain(logits, k: int, bias=None, norm_topk: bool = True):
    """logits: (T, E) float32 or bfloat16. Returns (top_p (T, k) float32,
    top_e (T, k) int32, counts (E,) int32)."""
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
    return top_p, top_e, counts
