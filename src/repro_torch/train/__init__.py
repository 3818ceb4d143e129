"""Training side of the port: the trainer, AdamW and its schedules, and the
durable checkpoint manager (which the reduct service builds on too)."""
from .checkpoint import CheckpointManager
from .optimizer import AdamW, AdamWState, constant_schedule, cosine_schedule
from .trainer import TrainConfig, Trainer, make_train_step

__all__ = [
    "CheckpointManager", "AdamW", "AdamWState", "constant_schedule",
    "cosine_schedule", "TrainConfig", "Trainer", "make_train_step",
]
