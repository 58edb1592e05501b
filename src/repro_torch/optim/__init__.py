"""Optimizers: AdamW and Adafactor (with its lean, stochastic-rounding
variant), the port of `repro.optim`."""
