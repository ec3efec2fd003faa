"""Architecture configuration registry of the plaintext LM path.

Port of ``repro/configs/__init__.py`` (``SHAPES``, ``ArchConfig``,
``param_count``, ``active_param_count``, ``reduced``,
``register``/``get_config``); the port keeps its own copy.  Every one
of the reference's ten architectures is ported: the dense GQA family
(``tinyllama-1.1b``, ``minitron-4b``, ``phi3-mini-3.8b``,
``deepseek-67b``), MLA with the dense -> MoE prefix
(``deepseek-v2-236b``, ``deepseek-v3-671b`` with its MTP head), the SSM
family (``mamba2-1.3b``), the hybrid Mamba / attention / MoE interleave
(``jamba-v0.1-52b``) and the two frontends (``hubert-xlarge``: audio
frames, encoder-only; ``pixtral-12b``: vision patch slots before the
text).  As in the reference, ``param_count`` counts neither the audio
``front_proj`` nor the MTP head.  ``remat`` (True by default, as the
reference's) recomputes each layer in the backward pass
(``nn/transformer.py``).

``active_param_count`` counts the MoE layers of the port's layer plan
(``nn/transformer.py``): in a jamba period the odd sub-layers.  The
reference's condition there never holds at jamba's period 8 and
``moe_every`` 2, so it returns the full count (ROADMAP.md §C).
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "register", "get_config"]

ARCH_IDS = [
    "minitron-4b", "phi3-mini-3.8b", "tinyllama-1.1b", "deepseek-67b",
    "deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b",
    "hubert-xlarge", "pixtral-12b", "mamba2-1.3b",
]

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    rope: bool = True
    rope_theta: float = 10000.0
    sliding_window: int = 0
    tie_embeddings: bool = False
    encoder_only: bool = False
    frontend: str = "none"      # none | audio | vision
    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_layers: int = 0
    moe_every: int = 1
    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # SSM / hybrid
    ssm: bool = False
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    ssd_chunk: int = 0          # 0 => nn.ssm.CHUNK (256)
    attn_period: int = 0
    mtp: bool = False
    # vlm
    n_patches: int = 0
    # full remat (save layer boundaries only) is the default, as the
    # reference's
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        return self.ssm or self.attn_period > 0

    def shape_supported(self, shape: str) -> tuple[bool, str]:
        kind = SHAPES[shape]["kind"]
        if kind == "decode" and not self.supports_decode:
            return False, "encoder-only: no autoregressive decode step"
        if shape == "long_500k" and not self.subquadratic:
            return False, "full quadratic attention: 500k decode infeasible"
        return True, ""

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), analytic."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_ffn = d * ff * (3 if self.gated_mlp else 2)
        if self.mla:
            r, rd = self.kv_lora_rank, self.rope_head_dim
            attn = (d * r + r * h * hd * 2 + d * rd + h * hd * d
                    + (d * self.q_lora_rank + self.q_lora_rank * h * (hd + rd)
                       if self.q_lora_rank else d * h * (hd + rd)))
        elif self.n_heads:
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        else:
            attn = 0
        moe_ffn = 0
        if self.moe:
            e_ff = self.moe_d_ff or ff
            moe_ffn = (self.n_experts * d * e_ff * (3 if self.gated_mlp else 2)
                       + d * self.n_experts
                       + self.n_shared_experts * d * e_ff
                       * (3 if self.gated_mlp else 2))
        mamba = 0
        if self.ssm:
            di = self.mamba_expand * d
            n = self.ssm_state
            mamba = (d * (2 * di + 2 * n + di // self.mamba_head_dim)
                     + di * d + self.mamba_d_conv * (di + 2 * n))
        total = emb
        for layer in range(self.n_layers):
            is_attn = (self.attn_period == 0
                       or (layer % self.attn_period) == self.attn_period - 1)
            if self.ssm and not (self.attn_period and is_attn):
                total += mamba
            elif self.n_heads:
                total += attn
            if self.n_heads or not self.ssm:
                use_moe = (self.moe and layer >= self.dense_layers
                           and (layer % self.moe_every) == 0)
                total += moe_ffn if use_moe else per_ffn
        return total

    def _moe_layers(self) -> int:
        """Layers whose FFN is MoE in the layer plan: a jamba period's odd
        sub-layers (``i % moe_every == 1``), elsewhere every layer from
        ``dense_layers`` on."""
        if not self.moe:
            return 0
        if self.attn_period:
            return sum(1 for layer in range(self.n_layers)
                       if (layer % self.attn_period) % self.moe_every == 1)
        return sum(1 for layer in range(self.dense_layers, self.n_layers)
                   if layer % self.moe_every == 0)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all
        experts)."""
        if not self.moe:
            return self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        per_expert = self.d_model * e_ff * (3 if self.gated_mlp else 2)
        inactive = (self.n_experts - self.experts_per_tok) * per_expert
        return self.param_count() - inactive * self._moe_layers()

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_d_ff=64 if self.moe else 0,
            kv_lora_rank=32 if self.mla else 0,
            q_lora_rank=48 if self.q_lora_rank else 0,
            rope_head_dim=16 if self.mla else 64,
            ssm_state=32 if self.ssm else 0,
            mamba_head_dim=32,
            dense_layers=min(self.dense_layers, 1),
            attn_period=min(self.attn_period, 4) if self.attn_period else 0,
            n_patches=16 if self.n_patches else 0,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        if name not in ARCH_IDS:
            raise ValueError(f"unknown arch {name!r}; the reference has "
                             + ", ".join(ARCH_IDS))
        importlib.import_module(
            f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return _REGISTRY[name]
