"""SeamlessM4T-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf]. The speech/text frontend is a STUB:
the encoder consumes precomputed frame embeddings
(`models.encdec.FRAME_DIM`).
n_layers applies to each of encoder and decoder (12 + 12).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    encoder_decoder=True, embed_frontend=True,
    source="arXiv:2308.11596",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_decoder=True, embed_frontend=True,
    )
