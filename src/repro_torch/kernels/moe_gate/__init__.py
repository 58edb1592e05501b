"""Fused top-k MoE gate: softmax, biased selection, top-k and the
per-expert histogram in one pass."""
from repro_torch.kernels.moe_gate.ops import moe_gate  # noqa: F401
