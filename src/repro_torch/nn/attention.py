"""GQA attention (llama family): prefill and one-token decode.

Port of ``repro/nn/attention.py`` ``:22-103`` (``gqa_init``,
``_split_heads``, ``_sdpa``, ``gqa_prefill``, ``gqa_decode``); MLA waits
(ROADMAP.md §A item 8).  Layouts as in the reference: ``(B, S, H, hd)``
heads, ``(B, Smax, Hkv, hd)`` caches.

Prefill takes a ``flash_impl(q, k, v) -> (B, S, H, hd)`` hook for causal
attention (``kernels.ops.flash_attention_op``, the B8 kernel on the card).
Its output is flattened to ``(B, S, H*hd)`` in the compute dtype before
``wo``, as ``_sdpa``'s is; the reference passes it on unflattened and its
flash route raises (ROADMAP.md §C).  ``gqa_decode`` writes the new key and
value into the cache in place and returns that cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import COMPUTE_DTYPE, apply_rope, dense, dense_init, param

__all__ = ["NEG_INF", "GQA", "gqa_init", "gqa_prefill", "gqa_decode"]

NEG_INF = -1e9


class GQA(nn.Module):
    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int,
                 device=None, gen=None):
        super().__init__()
        self.wq = param(dense_init(gen, d, n_heads * head_dim, device))
        self.wk = param(dense_init(gen, d, n_kv * head_dim, device))
        self.wv = param(dense_init(gen, d, n_kv * head_dim, device))
        self.wo = param(dense_init(gen, n_heads * head_dim, d, device))


def gqa_init(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
             device=None) -> GQA:
    return GQA(d, n_heads, n_kv, head_dim, device, gen)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa(q, k, v, causal: bool, q_pos=None, kv_len=None,
          sliding_window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,Hkv,hd) -> (B,Sq,H*hd) in the compute
    dtype.  GQA by head-group reshape (K/V are not repeated)."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qf = q.float() / math.sqrt(hd)
    qg = qf.reshape(b, sq, hkv, group, hd).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kg)
    skv = k.shape[1]
    kv_idx = torch.arange(skv, device=q.device)
    if causal:
        q_idx = torch.arange(sq, device=q.device) if q_pos is None else q_pos
        mask = kv_idx[None, :] <= q_idx[:, None]
        if sliding_window:
            mask &= kv_idx[None, :] > (q_idx[:, None] - sliding_window)
        scores = scores.masked_fill(~mask, NEG_INF)
    if kv_len is not None:  # decode: mask out unwritten cache slots
        scores = scores.masked_fill(kv_idx >= kv_len, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    vg = v.float().permute(0, 2, 1, 3)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, vg)
    vd = v.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * vd) \
        .to(COMPUTE_DTYPE)


def gqa_prefill(p: GQA, x: torch.Tensor, cfg, positions=None, causal=True,
                flash_impl=None):
    """x: (B,S,d) -> ((B,S,d), (k, v))."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _split_heads(dense(p, x, "wq"), cfg.n_heads, hd)
    k = _split_heads(dense(p, x, "wk"), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p, x, "wv"), cfg.n_kv_heads, hd)
    pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if flash_impl is not None and causal:
        attn = flash_impl(q, k, v).reshape(b, s, -1).to(COMPUTE_DTYPE)
    else:
        attn = _sdpa(q, k, v, causal=causal,
                     sliding_window=cfg.sliding_window)
    return dense(p, attn, "wo"), (k, v)


def gqa_decode(p: GQA, x: torch.Tensor, cache: dict, pos: int, cfg):
    """x: (B,1,d); cache: dict(k, v: (B,Smax,Hkv,hd)), updated in place at
    ``pos``."""
    hd = cfg.head_dim
    q = _split_heads(dense(p, x, "wq"), cfg.n_heads, hd)
    k = _split_heads(dense(p, x, "wk"), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p, x, "wv"), cfg.n_kv_heads, hd)
    posv = torch.full((1,), pos, device=x.device)
    if cfg.rope:
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    out = _sdpa(q, cache["k"], cache["v"], causal=False, kv_len=pos + 1,
                sliding_window=cfg.sliding_window)
    return dense(p, out, "wo"), cache
