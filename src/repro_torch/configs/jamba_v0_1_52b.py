"""Jamba-v0.1 52B [arXiv:2403.19887; hf].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Mamba:attention 7:1 interleave (1 attn layer per 8); MoE 16 experts top-2
every other layer.
Port of ``repro/configs/jamba_v0_1_52b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    act="silu", gated_mlp=True, norm="rmsnorm", rope=False,
    moe=True, n_experts=16, experts_per_tok=2, moe_d_ff=14336, moe_every=2,
    ssm=True, ssm_state=16, mamba_head_dim=64, mamba_expand=2, mamba_d_conv=4,
    attn_period=8,
))
