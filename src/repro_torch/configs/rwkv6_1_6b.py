"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892]. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, chunk=128, decay_lora=64, mix_lora=32),
    supports_long_context=True,
    source="arXiv:2404.05892",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        rwkv=RWKVConfig(head_dim=16, chunk=16, decay_lora=8, mix_lora=4),
        supports_long_context=True,
    )
