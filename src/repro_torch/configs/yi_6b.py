"""Yi-6B — llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=1e4,
    source="arXiv:2403.04652",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="yi-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
    )
