"""One-token attention against a KV cache, GQA kept grouped."""
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: F401
