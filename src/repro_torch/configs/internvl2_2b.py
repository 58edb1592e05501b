"""InternVL2-2B — InternViT frontend (STUB) + InternLM2-1.8B backbone
[arXiv:2404.16821; hf]. A batch's `vision_embeds` are
precomputed patch embeddings; the LM backbone is implemented in full.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, rope_theta=1e6,
    n_vision_tokens=256, embed_frontend=True,
    source="arXiv:2404.16821",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, n_vision_tokens=8, embed_frontend=True,
    )
