"""DeepSeek-V3 671B — MLA + 1 shared / 256 routed top-8 MoE + MTP
[arXiv:2412.19437; hf].

d_ff=18432 is the dense FFN of the first 3 layers; d_expert=2048 the
per-expert hidden dim. MTP depth 1.

A copy of the reference's config as the repo defines it: experts are
scored by softmax top-k, where the published model uses sigmoid scores
with node-limited routing (see ROADMAP.md).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280, rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, d_shared=2048, first_k_dense=3,
                  norm_topk_prob=True, aux_free_bias=True),
    mtp_depth=1,
    source="arXiv:2412.19437",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32,
                      num_shared_experts=1, d_shared=32, first_k_dense=1,
                      aux_free_bias=True),
        mtp_depth=1,
    )
