"""Knowledge distillation and the customization pipeline."""
from .kd import TrainResult, evaluate, kd_loss, train_bnn
from .pipeline import FAMILIES, MODES, PipelineRow, run_pipeline

__all__ = ["TrainResult", "evaluate", "kd_loss", "train_bnn", "FAMILIES",
           "MODES", "PipelineRow", "run_pipeline"]
