"""Fault-tolerant checkpointing (`manager.CheckpointManager`), the port
of `repro.checkpoint`."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
