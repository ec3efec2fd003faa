"""Attention variants: GQA (llama family, and the encoder's non-causal
attention) and MLA (deepseek v2/v3): prefill and one-token decode.

Port of ``repro/nn/attention.py`` (``gqa_init``, ``_split_heads``,
``_sdpa``, ``gqa_prefill``, ``gqa_decode``, ``mla_init``, ``_mla_q``,
``mla_prefill``, ``mla_decode``, ``mla_decode_absorbed``).  Layouts as in
the reference: ``(B, S, H, hd)`` heads, ``(B, Smax, Hkv, hd)`` GQA caches,
``{"c_kv": (B, Smax, r), "k_rope": (B, Smax, rd)}`` MLA caches.

Prefill takes a ``flash_impl(q, k, v) -> (B, S, H, hd)`` hook for causal
attention (``kernels.ops.flash_attention_op``, the B8 kernel on the card).
Its output is flattened to ``(B, S, H*hd)`` in the compute dtype before
``wo``, as ``_sdpa``'s is; the reference passes it on unflattened and its
flash route raises (ROADMAP.md §C).  The decode steps write the new
position into the cache in place and return that cache.

Under a tensor-parallel plan (``launch.tensor_parallel``) :func:`gqa_prefill`
takes the stream's sequence slice and runs H/m q heads on the gathered
sequence: ``wq`` on its local columns, the kv heads those q heads read,
``wo`` on its local rows (float32 partial sums reduce-scattered over the
sequence).  Where ``n_kv_heads`` splits over the m ranks, ``wk`` / ``wv``
are their local columns; else they are gathered over "model" and each
rank projects the kv heads its q heads read (its gradient to them
reduce-scattered back).  Where ``m`` does not divide ``n_heads``
(minitron-4b's 24 over 16) rank j runs heads ``[jH/m, (j+1)H/m)``, 1 or
2 of them: ``wq``'s columns and ``wo``'s rows cut at those head
boundaries from the leaves gathered whole over "model" in bf16 (their
gradient reduce-scattered back), each local q head reading its own kv
head where the heads do not fall in whole groups (the reference's
``_leaf_spec`` splits the storage at 1.5 heads a rank and GSPMD splits
the products, ``repro/launch/mesh.py:95-132``).  The flash hook (B8)
takes the local heads, with k and v contiguous.  MLA in train and
prefill runs H/m heads: ``w_uq`` (or
``wq``), ``w_uk`` and ``w_uv`` on their local columns (contiguous by
head), ``wo`` on its local rows; its latent projections ``w_dq``,
``w_dkv`` and ``w_kr``, column-sharded in storage but read whole by
every head, are gathered over "model" (their gradient reduce-scattered
back, as ``_local_kv`` does for kv heads), in bf16: they feed bf16
products only.

A decode step under a plan reads the rank's slice of the cache's
sequence (``launch.mesh.cache_specs``: positions j·S/m ... of every kv
head or of the latent) and the whole token: the token's q, k and v (or
MLA's latents) are column products on the rank's columns, gathered over
"model" (:func:`launch.tensor_parallel.columns`, a token's activations);
only the rank that owns ``pos`` writes the cache; every rank scores its
slice for every head and the softmax combines over "model"
(``tensor_parallel.softmax_combine``); ``wo`` runs on the rank's rows,
its float32 partial sums reduced once.  Absorbed MLA gathers the
absorbed queries of the rank's heads over heads and sums the weighted
latent (B x h x r) over "model" before ``w_uv`` and ``wo`` run on the
rank's heads.  The naive MLA decode gathers the token's q over heads
and ``w_uk`` / ``w_uv`` over "model" in bf16 (a weight, token-free:
2 x r x h·hd x 2 B a layer), expands only the rank's S/m latent
positions to every head's k and v, and scores them like GQA's slice.
As in the reference, decode masks only the slots past ``pos`` (its
``_sdpa`` call is not causal, so ``sliding_window`` does not apply
there).

MLA keeps a low-rank latent ``c_kv`` (r wide) and one shared RoPE key
(rd wide) a position.  Its q·k is hd + rd wide and its v hd wide, so it
always runs ``_sdpa`` in float32 (as the reference: B8's contract has one
head width for q, k and v), never the flash hook.  ``mla_decode`` expands
the whole latent cache to per-head K/V; ``mla_decode_absorbed`` folds
``w_uk`` into q and ``w_uv`` into the output and scores in the latent
space, scaled by 1/sqrt(hd + rd).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import (COMPUTE_DTYPE, apply_rope, dense, dense_init, matmul,
                     param, partial_matmul)

__all__ = ["NEG_INF", "GQA", "gqa_init", "gqa_prefill", "gqa_decode", "MLA",
           "mla_init", "mla_prefill", "mla_decode", "mla_decode_absorbed"]

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


def _attend(q, k, v, cfg, positions, causal, flash_impl):
    """RoPE'd q (B,S,H,hd) against k/v (B,S,Hkv,hd) -> (B,S,H*hd) and the
    RoPE'd k."""
    b, s = q.shape[:2]
    pos = torch.arange(s, device=q.device) if positions is None \
        else positions
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if flash_impl is not None and causal:
        out = flash_impl(q, k.contiguous(), v.contiguous())
        return out.reshape(b, s, -1).to(COMPUTE_DTYPE), k
    return _sdpa(q, k, v, causal=causal,
                 sliding_window=cfg.sliding_window), k


def _gqa_prefill(p, x: torch.Tensor, cfg, positions=None, causal=True,
                 flash_impl=None):
    hd = cfg.head_dim
    q = _split_heads(dense(p, x, "wq"), cfg.n_heads, hd)
    k = _split_heads(dense(p, x, "wk"), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p, x, "wv"), cfg.n_kv_heads, hd)
    attn, k = _attend(q, k, v, cfg, positions, causal, flash_impl)
    return dense(p, attn, "wo"), (k, v)


def _head_range(n_heads: int, st) -> tuple:
    """The q heads ``[h0, h1)`` of "model" rank ``st.j``: ``[jH/m,
    (j+1)H/m)``, H/m each where ``m`` divides H, else 1 or 2 (every rank
    at least one)."""
    if n_heads < st.m:
        raise ValueError(f"{n_heads} heads do not split over {st.m} model "
                         f"ranks: a rank would run none")
    return st.j * n_heads // st.m, (st.j + 1) * n_heads // st.m


def _local_kv(p: GQA, cfg, tp, h0: int, h1: int):
    """(wk, wv) columns of the kv heads this rank's q heads ``[h0, h1)``
    read, and the kv head of each local q head where the grouped reshape
    (``_sdpa``'s, B8's) would not map them so (else None); ``tp`` is
    ``launch.tensor_parallel``."""
    hd, m = cfg.head_dim, tp.current().m
    hl, group = h1 - h0, cfg.n_heads // cfg.n_kv_heads
    if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0 \
            and tp.split(p.wk, 1) and tp.split(p.wv, 1):
        return p.wk, p.wv, None
    kv0, kv1 = h0 // group, (h1 - 1) // group + 1
    cols = slice(kv0 * hd, kv1 * hd)
    wk = tp.whole(p.wk, True)[:, cols]
    wv = tp.whole(p.wv, True)[:, cols]
    idx = [(h0 + i) // group - kv0 for i in range(hl)]
    n = kv1 - kv0
    grouped = hl % n == 0 and idx == [i // (hl // n) for i in range(hl)]
    return wk, wv, None if grouped else idx


def gqa_prefill(p: GQA, x: torch.Tensor, cfg, positions=None, causal=True,
                flash_impl=None):
    """x: (B,S,d) -> ((B,S,d), (k, v)); under a tensor-parallel plan x and
    the output are the stream's sequence slices and (k, v) the local
    heads' (1 or 2 a rank where ``m`` does not divide the heads)."""
    from ..launch import tensor_parallel as tp
    st = tp.current()
    if st is None:
        return _gqa_prefill(p, x, cfg, positions, causal, flash_impl)
    hd = cfg.head_dim
    h0, h1 = _head_range(cfg.n_heads, st)
    xf = tp.enter(x)
    wk, wv, idx = _local_kv(p, cfg, tp, h0, h1)
    if cfg.n_heads % st.m == 0 and tp.split(p.wq, 1) and tp.split(p.wo, 0):
        wq, wo = p.wq, p.wo
    else:                  # uneven: cut at the rank's head boundaries
        cols = slice(h0 * hd, h1 * hd)
        wq = tp.whole(p.wq, True, COMPUTE_DTYPE)[:, cols]
        wo = tp.whole(p.wo, True, COMPUTE_DTYPE)[cols]
    hl = h1 - h0
    q = _split_heads(matmul(xf, wq), hl, hd)
    k = _split_heads(matmul(xf, wk), wk.shape[1] // hd, hd)
    v = _split_heads(matmul(xf, wv), wv.shape[1] // hd, hd)
    if idx is not None:               # one kv head a q head
        k, v = k[:, :, idx], v[:, :, idx]
    attn, k = _attend(q, k, v, cfg, positions, causal, flash_impl)
    y = tp.leave(partial_matmul(attn, wo), COMPUTE_DTYPE)
    return y, (k, v)


def gqa_decode(p: GQA, x: torch.Tensor, cache: dict, pos: int, cfg):
    """x: (B,1,d); cache: dict(k, v: (B,Smax,Hkv,hd)), updated in place at
    ``pos``; under a tensor-parallel plan the cache is the rank's sequence
    slice (B,Smax/m,Hkv,hd)."""
    from ..launch import tensor_parallel as tp
    if tp.current() is not None:
        return _gqa_decode_tp(p, x, cache, pos, cfg, tp)
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


def _write_own(cache: dict, new: dict, pos: int, first: int) -> None:
    """The new position's rows written into this rank's cache slice
    (positions ``first`` ...) where it owns ``pos``."""
    s = next(iter(cache.values())).shape[1]
    if first <= pos < first + s:
        for k, t in new.items():
            cache[k][:, pos - first:pos - first + 1] = t.to(cache[k].dtype)


def _past(scores, first: int, pos: int):
    """``scores`` (..., s) of positions ``first`` ... with the slots past
    ``pos`` masked, as ``_sdpa``'s ``kv_len`` mask."""
    idx = first + torch.arange(scores.shape[-1], device=scores.device)
    return scores.masked_fill(idx > pos, NEG_INF)


def _sdpa_slice(q, k, v, first: int, pos: int, tp) -> torch.Tensor:
    """``_sdpa`` of a decode token's q (B,1,H,hd) against this rank's cache
    slice k (B,s,Hkv,hd) / v (B,s,Hkv,hv) of positions ``first`` ...,
    every head, the softmax combined over "model" -> (B,1,H*hv) in
    float32."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = (q.float() / math.sqrt(hd)).reshape(b, sq, hkv, h // hkv, hd) \
        .permute(0, 2, 3, 1, 4)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                          k.float().permute(0, 2, 1, 3))
    vg = v.float().permute(0, 2, 1, 3)
    out = tp.softmax_combine(_past(scores, first, pos), lambda w:
                             torch.einsum("bhgqk,bhkd->bhgqd", w, vg))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, -1)


def _row_out(o: torch.Tensor, wo, tp) -> torch.Tensor:
    """``wo`` of every head's attention output ``o`` (B,1,H*hd), the same
    on every rank: this rank's rows of ``wo`` on its columns of ``o``,
    the float32 partial sums reduced over "model" and rounded once; a
    whole ``wo`` multiplied whole."""
    o = o.to(COMPUTE_DTYPE)
    if not tp.split(wo, 0):
        return matmul(o, tp.whole(wo, False))
    n = wo.shape[0]
    return tp.leave(partial_matmul(o.narrow(-1, tp.current().j * n, n), wo),
                    COMPUTE_DTYPE)


def _gqa_decode_tp(p: GQA, x, cache: dict, pos: int, cfg, tp):
    """The decode step on this rank's cache slice: the token's q, k and v
    gathered over "model", the owner of ``pos`` writing k and v, every
    head scored on the slice, ``wo`` on the rank's rows."""
    hd = cfg.head_dim
    q, k, v = tp.columns(x, p.wq, p.wk, p.wv)
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    if cfg.rope:
        posv = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    first = tp.current().j * cache["k"].shape[1]
    _write_own(cache, {"k": k, "v": v}, pos, first)
    out = _sdpa_slice(q, cache["k"], cache["v"], first, pos, tp)
    return _row_out(out, p.wo, tp), cache


# ---------------------------------------------------------------------------
# MLA (deepseek v2/v3): low-rank compressed KV cache
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The reference's ``mla_init`` dict: ``w_dkv`` (d, r), ``w_uk`` /
    ``w_uv`` (r, h·hd), ``w_kr`` (d, rd), ``wo`` (h·hd, d), and the query
    through ``w_dq`` (d, q_lora) and ``w_uq`` (q_lora, h·(hd + rd)), or
    ``wq`` (d, h·(hd + rd)) where ``q_lora_rank`` is 0."""

    def __init__(self, cfg, device=None, gen=None):
        super().__init__()
        d, r = cfg.d_model, cfg.kv_lora_rank
        h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
        self.w_dkv = param(dense_init(gen, d, r, device))
        self.w_uk = param(dense_init(gen, r, h * hd, device))
        self.w_uv = param(dense_init(gen, r, h * hd, device))
        self.w_kr = param(dense_init(gen, d, rd, device))
        self.wo = param(dense_init(gen, h * hd, d, device))
        if cfg.q_lora_rank:
            self.w_dq = param(dense_init(gen, d, cfg.q_lora_rank, device))
            self.w_uq = param(dense_init(gen, cfg.q_lora_rank, h * (hd + rd),
                                         device))
        else:
            self.wq = param(dense_init(gen, d, h * (hd + rd), device))


def mla_init(gen, cfg, device=None) -> MLA:
    return MLA(cfg, device, gen)


def _mla_q(p: MLA, x: torch.Tensor, cfg):
    """(q_nope (..., h, hd), q_rope (..., h, rd)), before RoPE."""
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = dense(p, dense(p, x, "w_dq"), "w_uq")
    else:
        q = dense(p, x, "wq")
    q = q.reshape(x.shape[:-1] + (h, hd + rd))
    return q[..., :hd], q[..., hd:]


def _mla_new_position(p: MLA, x: torch.Tensor, cache: dict, pos: int, cfg):
    """The decode steps' common half: q (RoPE'd at ``pos``) and the new
    latent and RoPE key written into ``cache`` at ``pos``."""
    q_nope, q_rope = _mla_q(p, x, cfg)
    posv = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    kr_new = apply_rope(dense(p, x, "w_kr")[..., None, :], posv,
                        cfg.rope_theta)[..., 0, :]
    cache["c_kv"][:, pos:pos + 1] = dense(p, x, "w_dkv") \
        .to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos:pos + 1] = kr_new.to(cache["k_rope"].dtype)
    return q_nope, q_rope


def _check_mla_split(p: MLA, cfg, tp) -> None:
    """Raises unless MLA's heads split over the plan's m ranks: ``m``
    divides them and the per-head leaves are this rank's heads'
    shards."""
    up = p.w_uq if cfg.q_lora_rank else p.wq
    m = tp.current().m
    if not (cfg.n_heads % m == 0 and tp.split(up, 1)
            and tp.split(p.w_uk, 1) and tp.split(p.w_uv, 1)
            and tp.split(p.wo, 0)):
        raise ValueError(f"MLA's {cfg.n_heads} heads do not split over "
                         f"{m} model ranks")


def mla_prefill(p: MLA, x: torch.Tensor, cfg, positions=None):
    """x: (B,S,d) -> ((B,S,d), (c_kv (B,S,r), k_rope (B,S,rd))); under a
    tensor-parallel plan x and the output are the stream's sequence
    slices, the layer runs H/m heads on the gathered sequence and
    (c_kv, k_rope) are the whole sequence's; raises where the heads do
    not split."""
    from ..launch import tensor_parallel as tp
    if tp.current() is None:
        return _mla_prefill(p, x, cfg, positions)
    _check_mla_split(p, cfg, tp)
    return _mla_prefill_tp(p, x, cfg, positions, tp)


def _mla_prefill(p, x: torch.Tensor, cfg, positions=None):
    b, s, _ = x.shape
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    c_kv = dense(p, x, "w_dkv")
    k_rope = apply_rope(dense(p, x, "w_kr")[..., None, :], pos,
                        cfg.rope_theta)                # (B,S,1,rd) shared
    k_nope = dense(p, c_kv, "w_uk").reshape(b, s, h, hd)
    v = dense(p, c_kv, "w_uv").reshape(b, s, h, hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rd)], dim=-1)
    out = _sdpa(q, k, v, causal=True)
    return dense(p, out, "wo"), (c_kv, k_rope[..., 0, :])


def _mla_prefill_tp(p: MLA, x, cfg, positions, tp):
    """MLA on this rank's H/m heads of the gathered sequence: the latent
    projections gathered whole in bf16 (their gradient reduce-scattered
    back),
    ``w_uq`` / ``w_uk`` / ``w_uv`` on their local columns, the float32
    ``_sdpa`` on the local heads, ``wo`` on its local rows."""
    hl = cfg.n_heads // tp.current().m
    hd, rd = cfg.head_dim, cfg.rope_head_dim
    xf = tp.enter(x)
    b, s, _ = xf.shape
    pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    if cfg.q_lora_rank:
        q = matmul(matmul(xf, tp.whole(p.w_dq, True, COMPUTE_DTYPE)), p.w_uq)
    else:
        q = matmul(xf, p.wq)
    q = q.reshape(b, s, hl, hd + rd)
    q_rope = apply_rope(q[..., hd:], pos, cfg.rope_theta)
    c_kv = matmul(xf, tp.whole(p.w_dkv, True, COMPUTE_DTYPE))
    k_rope = apply_rope(matmul(xf, tp.whole(p.w_kr, True, COMPUTE_DTYPE))[..., None, :],
                        pos, cfg.rope_theta)
    k_nope = matmul(c_kv, p.w_uk).reshape(b, s, hl, hd)
    v = matmul(c_kv, p.w_uv).reshape(b, s, hl, hd)
    q = torch.cat([q[..., :hd], q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, hl, rd)], dim=-1)
    out = _sdpa(q, k, v, causal=True)
    y = tp.leave(partial_matmul(out, p.wo), COMPUTE_DTYPE)
    return y, (c_kv, k_rope[..., 0, :])


def mla_decode(p: MLA, x: torch.Tensor, cache: dict, pos: int, cfg):
    """Naive decode: x (B,1,d); the whole latent cache expanded to per-head
    K/V, the slots past ``pos`` masked.  Under a tensor-parallel plan the
    cache is the rank's sequence slice (B,Smax/m,r) / (B,Smax/m,rd), and
    only that slice is expanded (:func:`_mla_decode_tp`)."""
    from ..launch import tensor_parallel as tp
    if tp.current() is not None:
        return _mla_decode_tp(p, x, cache, pos, cfg, tp)
    return _mla_decode(p, x, cache, pos, cfg)


def _mla_decode(p, x: torch.Tensor, cache: dict, pos: int, cfg):
    b = x.shape[0]
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    q_nope, q_rope = _mla_new_position(p, x, cache, pos, cfg)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s = c_kv.shape[1]
    k_nope = dense(p, c_kv, "w_uk").reshape(b, s, h, hd)
    v = dense(p, c_kv, "w_uv").reshape(b, s, h, hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)],
                  dim=-1)
    out = _sdpa(q, k, v, causal=False, kv_len=pos + 1)
    return dense(p, out, "wo"), cache


def _mla_token_tp(p: MLA, x, cache: dict, pos: int, cfg, tp):
    """A decode token's half common to both split routes: its q_nope and
    RoPE'd q_rope on the rank's heads (B,1,h/m,hd) / (B,1,h/m,rd), its
    latents gathered over "model" (``tensor_parallel.columns``) and
    written by the owner of ``pos`` into the rank's cache slice, and
    that slice's first position.  Raises where the heads do not split."""
    st = tp.current()
    _check_mla_split(p, cfg, tp)
    b = x.shape[0]
    hd, rd, hl = cfg.head_dim, cfg.rope_head_dim, cfg.n_heads // st.m
    if cfg.q_lora_rank:
        cq, c_new, kr_new = tp.columns(x, p.w_dq, p.w_dkv, p.w_kr)
        q = matmul(cq, p.w_uq)
    else:
        c_new, kr_new = tp.columns(x, p.w_dkv, p.w_kr)
        q = matmul(x, p.wq)
    q = q.reshape(b, 1, hl, hd + rd)
    posv = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q[..., hd:], posv, cfg.rope_theta)
    kr_new = apply_rope(kr_new[..., None, :], posv, cfg.rope_theta)[..., 0, :]
    first = st.j * cache["c_kv"].shape[1]
    _write_own(cache, {"c_kv": c_new, "k_rope": kr_new}, pos, first)
    return q[..., :hd], q_rope, first


def _mla_decode_tp(p: MLA, x, cache: dict, pos: int, cfg, tp):
    """Naive decode on this rank's cache slice: the token's q gathered
    over heads, ``w_uk`` / ``w_uv`` gathered over "model" in bf16 and the
    slice's S/m latent positions expanded to every head's k and v, every
    head scored on the slice (the softmax combined over "model"), ``wo``
    on the rank's rows."""
    b = x.shape[0]
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    q_nope, q_rope, first = _mla_token_tp(p, x, cache, pos, cfg, tp)
    q = tp.gather_model(torch.cat([q_nope, q_rope], dim=-1), 2, False)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s = c_kv.shape[1]
    k_nope = matmul(c_kv, tp.whole(p.w_uk, False, COMPUTE_DTYPE)) \
        .reshape(b, s, h, hd)
    v = matmul(c_kv, tp.whole(p.w_uv, False, COMPUTE_DTYPE)) \
        .reshape(b, s, h, hd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)],
                  dim=-1)
    return _row_out(_sdpa_slice(q, k, v, first, pos, tp), p.wo, tp), cache


def mla_decode_absorbed(p: MLA, x: torch.Tensor, cache: dict, pos: int,
                        cfg):
    """Absorbed decode (deepseek-v2 §2.1): q_nope·w_ukᵀ scores against the
    latent cache itself, the attention output leaves the latent space
    through ``w_uv``; the cache is never expanded to h heads.  Under a
    tensor-parallel plan the cache is the rank's sequence slice
    (B,Smax/m,r) / (B,Smax/m,rd)."""
    from ..launch import tensor_parallel as tp
    if tp.current() is not None:
        return _mla_decode_absorbed_tp(p, x, cache, pos, cfg, tp)
    return _mla_decode_absorbed(p, x, cache, pos, cfg)


def _mla_decode_absorbed(p, x: torch.Tensor, cache: dict, pos: int, cfg):
    b = x.shape[0]
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope = _mla_new_position(p, x, cache, pos, cfg)
    c_kv = cache["c_kv"].float()
    s = c_kv.shape[1]
    w_uk = p.w_uk.reshape(r, h, hd).to(COMPUTE_DTYPE)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)   # bf16, as ref
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             cache["k_rope"].float()))
    scores = scores / math.sqrt(hd + rd)
    scores = scores.masked_fill(torch.arange(s, device=x.device) > pos,
                                NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", w, c_kv)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat,
                       p.w_uv.reshape(r, h, hd).float())
    out = out.reshape(b, 1, h * hd).to(COMPUTE_DTYPE)
    return dense(p, out, "wo"), cache


def _mla_decode_absorbed_tp(p: MLA, x, cache: dict, pos: int, cfg, tp):
    """Absorbed decode on this rank's cache slice: the token's latents
    gathered over "model" (the owner of ``pos`` writes them), the
    absorbed queries of the rank's heads gathered over heads, every head
    scored on the slice, the weighted latent summed over "model", then
    ``w_uv`` and ``wo`` on the rank's heads."""
    st = tp.current()
    b = x.shape[0]
    hd, rd = cfg.head_dim, cfg.rope_head_dim
    r, hl = cfg.kv_lora_rank, cfg.n_heads // st.m
    q_nope, q_rope, first = _mla_token_tp(p, x, cache, pos, cfg, tp)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p.w_uk.reshape(r, hl, hd).to(COMPUTE_DTYPE))
    qa = tp.gather_model(torch.cat([q_lat, q_rope], -1), 2, False)
    c_kv = cache["c_kv"].float()
    scores = (torch.einsum("bqhr,bsr->bhqs", qa[..., :r].float(), c_kv)
              + torch.einsum("bqhr,bsr->bhqs", qa[..., r:].float(),
                             cache["k_rope"].float()))
    scores = _past(scores / math.sqrt(hd + rd), first, pos)
    o_lat = tp.softmax_combine(scores, lambda w: torch.einsum(
        "bhqs,bsr->bhqr", w, c_kv))                      # (B,h,1,r)
    o_lat = o_lat[:, st.j * hl:(st.j + 1) * hl].permute(0, 2, 1, 3)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat,
                       p.w_uv.reshape(r, hl, hd).float())
    out = out.reshape(b, 1, hl * hd).to(COMPUTE_DTYPE)
    return tp.leave(partial_matmul(out, p.wo), COMPUTE_DTYPE), cache
