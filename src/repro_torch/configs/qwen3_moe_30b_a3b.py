"""Qwen3-30B-A3B — 128-expert top-8 MoE, GQA [hf:Qwen/Qwen3-30B-A3B].

A copy of the reference's config as the repo defines it: head_dim
resolves to d_model / n_heads = 64 and there is no QK-norm, where the
published model has head_dim 128 and QK-norm (see ROADMAP.md).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768,
                  num_shared_experts=0, d_shared=0,
                  norm_topk_prob=True, aux_free_bias=False),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64,
                      norm_topk_prob=True, aux_free_bias=False),
    )
