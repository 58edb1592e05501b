"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Hybrid: runs the long_500k cell. The shared
transformer block (full attention + MLP at 2 x d_model, weights shared
across invocations) is applied every 6 mamba layers; the per-invocation
LoRA adapters of the released model are omitted, as in the reference.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    shared_every=6, supports_long_context=True,
    source="arXiv:2411.15242",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        shared_every=2, supports_long_context=True,
    )
