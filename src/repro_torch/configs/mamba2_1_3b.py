"""Mamba2-1.3B [arXiv:2405.21060; unverified].
48L d_model=2048 attention-free, vocab=50280, ssm_state=128, SSD blocks.
Port of ``repro/configs/mamba2_1_3b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    act="silu", gated_mlp=False, norm="rmsnorm", rope=False,
    ssm=True, ssm_state=128, mamba_head_dim=64, mamba_expand=2,
    mamba_d_conv=4, tie_embeddings=True,
))
