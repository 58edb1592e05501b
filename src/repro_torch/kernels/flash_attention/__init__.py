"""Online-softmax attention (prefill and training), GQA read in place:
the forward kernel and its backward."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention)
