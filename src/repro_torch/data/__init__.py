"""Synthetic offline datasets (numpy)."""
from .synthetic import IMAGE_DATASETS, image_dataset, token_stream

__all__ = ["IMAGE_DATASETS", "image_dataset", "token_stream"]
