"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671; hf].

28 heads do not divide the 16-way model axis; the sharding layer
falls back to sequence-sharded attention for this arch (see
repro/parallel/sharding.py and DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
        d_ff=128, vocab_size=256, qkv_bias=True,
    )
