"""Optimizers: AdamW and Adafactor (with its lean, stochastic-rounding
variant), the port of `repro.optim`."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_apply, adamw_init)
