"""LM training: the loop and its checkpoints."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .trainer import Trainer, TrainerConfig

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint", "Trainer",
           "TrainerConfig"]
