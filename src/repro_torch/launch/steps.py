"""The serve step — the port of `repro.launch.steps.build_serve_step`
on one device (no shardings or jit signatures: PyTorch runs eagerly).
Training waits for a later slice."""
from __future__ import annotations

import torch

from repro_torch.models import lm as lm_mod


def argmax_first(logits):
    """argmax over the last dim taking the FIRST maximal index, as
    jnp.argmax does: bf16 logits tie often enough for this to matter."""
    V = logits.shape[-1]
    top = logits.max(-1, keepdim=True).values
    ids = torch.arange(V, device=logits.device)
    return torch.where(logits == top, ids, V).min(-1).values.to(torch.int32)


def build_serve_step(cfg):
    """serve_step(params, extras, cache, tokens, pos) -> (cache,
    next_tokens (B,) int32): one greedy decode step. The cache is
    updated in place."""
    lm_mod.check_ported(cfg)

    def serve_step(params, extras, cache, tokens, pos):
        cache, logits = lm_mod.decode_step(params, cache, tokens, pos,
                                           extras, cfg)
        return cache, argmax_first(logits)

    return serve_step
