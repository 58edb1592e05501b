"""Online-softmax attention forward (prefill), GQA read in place."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention)
