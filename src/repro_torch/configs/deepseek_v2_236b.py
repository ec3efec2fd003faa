"""DeepSeek-V2 236B [arXiv:2405.04434; hf].
60L d_model=5120 128H d_ff=1536(expert) vocab=102400.
MLA kv_lora=512 q_lora=1536; MoE 2 shared + 160 routed top-6; first layer dense
(d_ff_dense=12288).
Port of ``repro/configs/deepseek_v2_236b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab=102400,
    act="silu", gated_mlp=True, norm="rmsnorm", rope=True,
    moe=True, n_experts=160, experts_per_tok=6, n_shared_experts=2,
    moe_d_ff=1536, dense_layers=1,
    mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
))
