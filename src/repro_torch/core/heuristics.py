"""Self-clustering heuristics #1/#2/#3 (paper §4.3), the port of
`repro.core.heuristics`.

All three compare, per SE, the external-interaction count toward the
most-contacted remote LP (epsilon) against the internal count (iota);
an SE migrates when alpha = eps/iota > MF and at least MT timesteps
passed since its last migration. They differ in the window:

  #1 sliding window over the last kappa *timesteps*
  #2 sliding window over the last omega *sending events*
  #3 = #2, but evaluated only after zeta interactions since last eval

Pure functions: the window ring is updated out of place, as in the
reference. Each takes a leading replica axis too: the ring (R, w, N, L)
and per-SE inputs (R, N, ...), with a per-replica MF; replica r gets
what a solo call on its slice gets.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import neighbors
from repro_torch.fp32 import div32, f32


@dataclasses.dataclass(frozen=True)
class HeuristicConfig:
    kind: int = 1  # 1 | 2 | 3
    mf: float = 1.2  # Migration Factor (alpha threshold)
    mt: int = 10  # Migration Threshold (timesteps between migrations)
    kappa: int = 10  # #1: window length in timesteps
    omega: int = 8  # #2/#3: window length in sending events
    zeta: int = 16  # #3: interactions between evaluations

    def __post_init__(self):
        if self.kind not in (1, 2, 3):
            raise ValueError(f"heuristic kind={self.kind} not in (1, 2, 3)")
        if self.mf < 0:
            raise ValueError("mf (Migration Factor) must be >= 0")
        if self.mt < 0:
            raise ValueError("mt (Migration Threshold) must be >= 0")
        if self.kappa < 1 or self.omega < 1 or self.zeta < 1:
            raise ValueError("window parameters kappa/omega/zeta must "
                             "be >= 1")


def init_state(cfg: HeuristicConfig, n_se: int, n_lp: int, device):
    w = cfg.kappa if cfg.kind == 1 else cfg.omega
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "ring": torch.zeros((w, n_se, n_lp), **i32),
        "ptr": torch.zeros((n_se,), **i32),  # #2/#3 event write pointer
        "since_eval": torch.zeros((n_se,), **i32),  # #3 counter
        "last_mig": torch.full((n_se,), -10**6, **i32),
    }


def update_window(cfg: HeuristicConfig, state, counts, sender_mask, t: int):
    """Push this timestep's per-SE destination histogram into the window."""
    ring = state["ring"].clone()
    zero = torch.zeros_like(counts)
    if cfg.kind == 1:
        # timestep window: every SE's slot advances each step
        ring[..., t % cfg.kappa, :, :] = torch.where(sender_mask[..., None],
                                                     counts, zero)
        return dict(state, ring=ring)
    # event window: only senders advance their own pointer; row ptr * N
    # + i of each replica's (w * N, L) block of the flat ring
    w, n, L = ring.shape[-3:]
    ptr = state["ptr"].long()
    rows = ptr * n + torch.arange(n, device=counts.device)
    if ptr.dim() > 1:
        rows = rows + neighbors.replica_offsets(ptr.shape[0], w * n,
                                                counts.device)
    flat = ring.view(-1, L)
    cur = flat[rows]
    flat[rows] = torch.where(sender_mask[..., None], counts, cur)
    new_ptr = torch.where(sender_mask, (state["ptr"] + 1) % cfg.omega,
                          state["ptr"])
    since = state["since_eval"] + torch.where(
        sender_mask, counts.sum(-1, dtype=torch.int32),
        torch.zeros_like(state["since_eval"]))
    return dict(state, ring=ring, ptr=new_ptr, since_eval=since)


def evaluate(cfg: HeuristicConfig, state, lp, t: int, valid=None, mf=None):
    """Returns (candidate (N,), dest_lp (N,), alpha (N,), new_state,
    n_evals) — with a replica axis (R, N) each and n_evals (R,). `mf`
    overrides cfg.mf (taken as float32); a batch may give an (R,)
    float32 tensor of per-replica MFs."""
    if isinstance(mf, torch.Tensor):
        mf = mf[..., None]  # (R, 1): replica r's MF against its rows
    else:
        mf = f32(cfg.mf if mf is None else mf)
    L = state["ring"].shape[-1]
    window = state["ring"].sum(-3, dtype=torch.int32)  # (..., N, L)
    safe_lp = lp.clamp(0, L - 1).long()
    local = window.gather(-1, safe_lp[..., None])[..., 0]
    ext = window.scatter(-1, safe_lp[..., None], 0)
    eps = ext.amax(-1)
    dest = ext.argmax(-1).to(torch.int32)  # first index on ties
    alpha = div32(eps, local.clamp(min=1))
    if valid is None:
        valid = torch.ones(lp.shape, dtype=torch.bool, device=lp.device)
    eligible = valid & ((t - state["last_mig"]) >= cfg.mt)
    if cfg.kind == 3:
        do_eval = valid & (state["since_eval"] >= cfg.zeta)
        n_evals = do_eval.sum(-1, dtype=torch.int32)
        state = dict(state, since_eval=torch.where(
            do_eval, torch.zeros_like(state["since_eval"]),
            state["since_eval"]))
    else:
        do_eval = valid
        n_evals = valid.sum(-1, dtype=torch.int32)
    candidate = do_eval & eligible & (alpha > mf) & (eps > 0)
    return candidate, dest, alpha, dict(state), n_evals
