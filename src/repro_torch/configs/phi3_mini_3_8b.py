"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified].
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064, RoPE SwiGLU.
Port of ``repro/configs/phi3_mini_3_8b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    act="silu", gated_mlp=True, norm="rmsnorm", rope=True,
))
