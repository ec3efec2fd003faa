"""Optimizers over a name -> tensor mapping."""
from .adamw import OptConfig, adamw_init, adamw_update, sgd_update

__all__ = ["OptConfig", "adamw_init", "adamw_update", "sgd_update"]
