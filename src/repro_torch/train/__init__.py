"""Training-side pieces of the port.  So far the durable checkpoint manager
the reduct service builds on; the trainer and optimizer come with LM
training (ROADMAP)."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
