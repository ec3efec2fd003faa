"""Minitron-4B: width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf].
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, squared-ReLU MLP.
Port of ``repro/configs/minitron_4b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000,
    act="sq_relu", gated_mlp=False, norm="layernorm", rope=True,
))
