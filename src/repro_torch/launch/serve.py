"""Batched greedy serving of an LM, with GAIA expert placement online
for an MoE one — the loop of the reference's `examples/serve_moe.py` as
a function.

Prefill the prompts, then decode greedily. After each decode step GAIA
observes the step's traffic (synthesised from the generated tokens as
the example does: row b belongs to group b % G and sends 10 tokens to
expert token % E) and, every `interval` steps, may migrate experts:
the stored expert weights are permuted once, in place, and the routing
table (`extras["placement"]`) follows.

    python -m repro_torch.launch.serve --smoke --device cpu

Unlike the example, the permutation the weights are currently stored in
is kept and passed as `perm_old` to `gaia_moe.migration_index`; the
example passes the identity on every migration, so from its second
migration on its stored weights no longer match its routing table.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.core import gaia_moe as gm
from repro_torch.core.service import resolve_device
from repro_torch.launch.steps import argmax_first
from repro_torch.models import lm as lm_mod

#: the expert leaves a migration permutes
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def example_gaia_config(cfg) -> gm.GaiaMoEConfig:
    """GAIA-MoE as `examples/serve_moe.py` configures it, for cfg's
    experts."""
    return gm.GaiaMoEConfig(num_experts=cfg.moe.num_experts, num_groups=4,
                            mf=1.2, mt=8, window=4, interval=8)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traffic(tokens, G: int, E: int):
    """(G, E) traffic of one step: row b is in group b % G and sends 10
    tokens to expert tokens[b] % E."""
    B = tokens.shape[0]
    grp = torch.arange(B, device=tokens.device) % G
    hot = tokens.long() % E
    out = torch.zeros((G, E), dtype=torch.float32, device=tokens.device)
    return out.index_put_((grp, hot), torch.full((B,), 10.0,
                                                  device=tokens.device),
                          accumulate=True)


def serve(cfg, gaia_cfg, batch: int, prompt_len: int, gen: int, seed: int,
          device=None, *, params=None, prompts=None, forced=None,
          keep_logits: bool = False) -> dict:
    """Prefill `batch` prompts of `prompt_len` tokens and decode `gen`
    greedy steps, with GAIA expert placement (`gaia_cfg`, None for off;
    a dense config serves with None).

    Weights are drawn from `seed` on the device unless `params` is given
    (its expert leaves are then permuted in place by migrations);
    prompts from seed + 1 on the CPU unless `prompts` (B, prompt_len) is
    given. `forced` (B, gen + 1) teacher-forces the token stream: step i
    feeds forced[:, i] and GAIA observes forced[:, i + 1].

    Returns {"tokens": (B, gen + 1) int32 greedy picks, "logits": the
    prefill's last and each step's (B, V) logits if `keep_logits`,
    "migrations", "migration_steps", "placement" (expert -> shard),
    "perm" (expert -> segment), "prefill_s", "decode_s"}; tensors on the
    CPU except the logits."""
    dev = resolve_device(device)
    lm_mod.check_ported(cfg)
    if cfg.moe is None and gaia_cfg is not None:
        raise ValueError(f"{cfg.name} has no MoE layers to place")
    E, L = (cfg.moe.num_experts if cfg.moe else 0), cfg.n_layers
    if gaia_cfg is not None and gaia_cfg.num_experts != E:
        raise ValueError(f"gaia_cfg.num_experts={gaia_cfg.num_experts} != "
                         f"the model's {E} experts")
    if params is None:
        params = lm_mod.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
    extras = lm_mod.init_extras(cfg, dev)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len),
            generator=torch.Generator().manual_seed(seed + 1))
    prompts = prompts.to(dev)
    if forced is not None:
        forced = forced.to(device=dev, dtype=torch.int32)
    cache_len = prompt_len + gen

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = lm_mod.prefill(params, {"tokens": prompts}, cfg,
                                   cache_len)
    picks = [argmax_first(logits[:, -1])]
    kept = [logits[:, -1]] if keep_logits else None
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    gstate = None if gaia_cfg is None else gm.init_state(gaia_cfg, dev)
    perm = torch.arange(E, dtype=torch.int32, device=dev)
    migrations, migration_steps = 0, []
    t0 = time.perf_counter()
    for step in range(gen):
        fed = picks[-1] if forced is None else forced[:, step]
        cache, logits = lm_mod.decode_step(params, cache, fed,
                                           prompt_len + step, extras, cfg)
        picks.append(argmax_first(logits))
        if keep_logits:
            kept.append(logits)
        if gstate is None:
            continue
        nxt = picks[-1] if forced is None else forced[:, step + 1]
        gstate, n = gm.maybe_update(
            gaia_cfg, gstate, _traffic(nxt, gaia_cfg.num_groups, E))
        n = int(n)  # waits for the card on evaluation steps only
        if n:
            new_perm, order = gm.placement_permutation(gstate["placement"],
                                                       E)
            idx = gm.migration_index(perm, order)[None].expand(L, E)
            for name in EXPERT_LEAVES:
                gm.apply_migration_stacked(params["layers"]["moe"][name],
                                           idx)
            extras["placement"] = new_perm[None].repeat(L, 1)
            perm = new_perm
            migrations += n
            migration_steps.append(step)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "tokens": torch.stack(picks, 1).cpu(),
        "logits": kept,
        "migrations": migrations,
        "migration_steps": migration_steps,
        "placement": None if gstate is None else gstate["placement"].cpu(),
        "perm": perm.cpu(),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--no-gaia", action="store_true")
    a = ap.parse_args(argv)
    cfg = get_smoke(a.arch) if a.smoke else get_arch(a.arch)
    gcfg = (None if a.no_gaia or cfg.moe is None
            else example_gaia_config(cfg))
    out = serve(cfg, gcfg, a.batch, a.prompt_len, a.gen, a.seed, a.device)
    print(json.dumps({
        "arch": cfg.name, "batch": a.batch, "prompt_len": a.prompt_len,
        "gen": a.gen, "migrations": out["migrations"],
        "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tokens_per_s": a.batch * a.gen / out["decode_s"],
        "sample": out["tokens"][0, :16].tolist()}))


if __name__ == "__main__":
    main()
