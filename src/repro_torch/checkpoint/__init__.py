"""Fault-tolerant checkpointing (`manager.CheckpointManager`), the port
of `repro.checkpoint`."""
