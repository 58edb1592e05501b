"""GAIA self-clustering adapted to MoE expert placement — the port of
`repro.core.gaia_moe`.

  SE       -> expert                (the migratable unit)
  LP       -> EP shard              (expert-parallel rank)
  message  -> routed token          (dispatch all-to-all traffic)
  MigComm  -> expert weight move    (3 * d * d_expert params)

Heuristic #1 per expert: alpha = eps / iota, the max traffic from any
other group over the traffic from its own shard's group; a candidate
when alpha > MF and MT steps have passed since it last moved, toward the
hottest group; the symmetric balancer of §4.4 (`core/balance.py`) keeps
E/G experts on every shard.

The state's `ptr` and `step` are host integers (the reference keeps
int32 scalars on the device): `maybe_update`'s `lax.cond` on the
interval becomes a Python `if` that never waits for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import balance as bal


@dataclasses.dataclass(frozen=True)
class GaiaMoEConfig:
    num_experts: int = 64
    num_groups: int = 8  # EP shards
    mf: float = 1.2
    mt: int = 200  # steps between migrations of one expert
    window: int = 8  # EMA-ish window of traffic snapshots
    interval: int = 100  # evaluate placement every `interval` steps


def init_state(cfg: GaiaMoEConfig, device):
    E, G = cfg.num_experts, cfg.num_groups
    if E % G:
        raise ValueError(f"num_experts={E} is not a multiple of "
                         f"num_groups={G}")
    return {
        "placement": torch.arange(E, dtype=torch.int32, device=device) % G,
        "traffic": torch.zeros((cfg.window, G, E), dtype=torch.float32,
                               device=device),
        "ptr": 0,
        "last_mig": torch.full((E,), -10**6, dtype=torch.int32,
                               device=device),
        "step": 0,
    }


def observe(cfg: GaiaMoEConfig, state, group_expert_counts):
    """Push a (G, E) token-traffic snapshot (from moe_fwd metrics)."""
    tr = state["traffic"].clone()
    tr[state["ptr"] % cfg.window] = group_expert_counts.float()
    return dict(state, traffic=tr, ptr=state["ptr"] + 1,
                step=state["step"] + 1)


def a2a_bytes(placement, group_expert_counts, token_bytes: int):
    """All-to-all payload: tokens whose source group != expert's
    shard."""
    G, E = group_expert_counts.shape
    groups = torch.arange(G, device=placement.device)
    on_shard = placement[None, :] == groups[:, None]  # (G, E)
    remote = torch.where(on_shard, 0.0, group_expert_counts.float()).sum()
    return remote * token_bytes


def evaluate(cfg: GaiaMoEConfig, state) -> Tuple[dict, torch.Tensor]:
    """Heuristic #1 + symmetric balancing over experts.

    Returns (new_state, n_migrations), the count a 0-d int tensor."""
    E, G = cfg.num_experts, cfg.num_groups
    window = state["traffic"].sum(0)  # (G, E)
    placement = state["placement"]
    t = state["step"]
    rows = torch.arange(E, device=placement.device)

    local = window.T[rows, placement.long()]
    ext = window.T.clone()
    ext[rows, placement.long()] = 0.0  # (E, G)
    eps = ext.max(-1).values
    dest = ext.argmax(-1).to(torch.int32)  # first index on ties
    alpha = eps / local.clamp(min=1.0)
    eligible = (t - state["last_mig"]) >= cfg.mt
    cand = eligible & (alpha > cfg.mf) & (eps > 0)

    cmat = bal.candidate_matrix(cand, placement, dest, G)
    grants = bal.symmetric_grants(cmat)
    admit = bal.select_migrations(cand, placement, dest, alpha, grants, G)
    state = dict(state,
                 placement=torch.where(admit, dest, placement),
                 last_mig=torch.where(admit, torch.full_like(
                     state["last_mig"], t), state["last_mig"]))
    return state, admit.sum()


def placement_permutation(placement_shard, num_experts: int):
    """Expert->shard map to the expert->segment permutation the MoE
    layer consumes. Segments are shard-major, so with E/G experts per
    shard the segment's owner is the expert's shard.

    Returns (perm (E,), order (E,)): perm[e] = segment of expert e;
    order[s] = expert served by segment s."""
    order = torch.argsort(placement_shard, stable=True)  # segment -> expert
    perm = torch.empty(num_experts, dtype=torch.int32,
                       device=placement_shard.device)
    perm[order] = torch.arange(num_experts, dtype=torch.int32,
                               device=placement_shard.device)
    return perm, order.to(torch.int32)


def migration_bytes(n_migrations, d_model: int, d_expert: int,
                    bytes_per_param: int = 2):
    """MigComm for expert moves (3 SwiGLU matrices per expert)."""
    return n_migrations * 3 * d_model * d_expert * bytes_per_param


# ---------------------------------------------------------------------------
# Physical migration (the paper's serialized SE-state transfer, Eq. 6)
# ---------------------------------------------------------------------------
#
# Expert weights are stored in segment order (models/moe.py): segment s
# holds the weights of the expert currently placed there. A placement
# change permutes the expert axis of every expert leaf once.


def migration_index(perm_old, order_new):
    """Row index for the segment-ordered store after a placement change.

    perm_old[e] = old segment of expert e; order_new[s] = expert that the
    new placement puts on segment s. stored_new[s] = stored_old[idx[s]].
    From the second migration on, perm_old is the permutation the
    weights were last stored in, not the identity."""
    return perm_old[order_new.long()]


def apply_migration(expert_leaf, idx, expert_axis: int = 0):
    """Permute the expert axis of one leaf: out[s] = leaf[idx[s]]."""
    return torch.index_select(expert_leaf, expert_axis, idx.long())


def apply_migration_stacked(stacked_leaf, idx_per_layer):
    """(L, E, ...) leaf with per-layer (L, E) indices, permuted IN PLACE
    one layer at a time. The reference's `jnp.take` over the whole leaf
    would copy it (19.3 GB for one qwen3-moe-30b-a3b expert leaf beside
    60 GB of weights); here the only temporary is one layer's leaf
    (201 MB). Returns the same tensor."""
    for i in range(stacked_leaf.shape[0]):
        stacked_leaf[i] = stacked_leaf[i].index_select(
            0, idx_per_layer[i].long())
    return stacked_leaf


def count_moves(idx_per_layer):
    """Number of experts that physically changed segment."""
    E = idx_per_layer.shape[-1]
    rows = torch.arange(E, device=idx_per_layer.device)
    return (idx_per_layer != rows[None, :]).sum()


def maybe_update(cfg: GaiaMoEConfig, state, group_expert_counts):
    """Per-step update: observe traffic; every `interval` steps evaluate.
    Returns (state, n_migrations): a 0-d tensor on evaluation steps, the
    int 0 on the others."""
    state = observe(cfg, state, group_expert_counts)
    if state["step"] % cfg.interval == 0:
        return evaluate(cfg, state)
    return state, 0
