"""HuBERT X-Large [arXiv:2106.07447; unverified].
48L encoder-only d_model=1280 16H d_ff=5120 vocab=504 (codebook targets).
Audio frontend (CNN feature extractor) STUBBED: input_specs() provides
precomputed 1280-d frame embeddings (DESIGN.md §5).
Port of ``repro/configs/hubert_xlarge.py``."""
from . import ArchConfig, register

register(ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    act="gelu", gated_mlp=False, norm="layernorm", rope=False,
    encoder_only=True, frontend="audio",
))
