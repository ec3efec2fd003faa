"""DeepSeek-V3 671B [arXiv:2412.19437; hf].
61L d_model=7168 128H vocab=129280. MLA kv_lora=512 q_lora=1536;
MoE 1 shared + 256 routed top-8, first 3 layers dense (d_ff=18432);
MTP: one extra multi-token-prediction head.
Port of ``repro/configs/deepseek_v3_671b.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    act="silu", gated_mlp=True, norm="rmsnorm", rope=True,
    moe=True, n_experts=256, experts_per_tok=8, n_shared_experts=1,
    moe_d_ff=2048, dense_layers=3,
    mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    mtp=True,
))
