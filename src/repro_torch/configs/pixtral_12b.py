"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified].
Backbone (mistral-nemo style): 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  Vision frontend (Pixtral-ViT) STUBBED: input_specs() provides
precomputed patch embeddings occupying the first n_patches slots.
Port of ``repro/configs/pixtral_12b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    act="silu", gated_mlp=True, norm="rmsnorm", rope=True,
    frontend="vision", n_patches=1024,
))
