"""Model assembly of the plaintext LM path: parameters, the prefill forward,
the training loss and the one-token decode step, for the dense GQA family,
MLA with deepseek's dense -> MoE prefix and MTP head, the SSM family, the
hybrid jamba interleave (Mamba-2 and attention sub-layers, MLP and MoE
FFNs) and the audio and vision frontends.

Port of ``repro/nn/transformer.py`` (``layer_groups``, ``_ffn_init``,
``_layer_init``, ``init_params``, ``_ffn_apply``, ``_block_fwd``,
``_embed_inputs``, ``forward``, ``_ce``, ``MTP_WEIGHT``, ``loss_fn``,
``_layer_cache``/``init_cache``, ``abstract_params``, ``abstract_cache``,
``_block_decode``, ``decode_step``, ``prefill_step``).  The reference
stacks each group's layers on a leading axis and runs them with
``lax.scan``; here the layers are an ``nn.ModuleList`` walked by a Python
loop.  Where ``cfg.remat`` (the default, as the reference's) and
gradients are on, each layer runs under ``torch.utils.checkpoint``
(non-reentrant; the reference's ``jax.checkpoint`` of the scan body,
``repro/nn/transformer.py:218-219``) and each jamba sub-layer under a
nested one (``:169-173``): the backward pass keeps the layer boundaries
and recomputes the rest.  Caches are one dict per layer, updated in place
by the decode step.

Under a tensor-parallel plan (``launch.tensor_parallel``: the train,
prefill and decode steps of a mesh) the residual stream between layers
is the rank's slice of the sequence (the reference's ``shard_hint(h, "batch",
"seq", None)``) and norms run on it.  A vocabulary that splits over the
m "model" ranks gives a vocab-parallel embedding (each rank looks up its
rows, zeros elsewhere, and the sums reduce-scatter over the sequence), a
vocab-parallel head (logits (B, S, V/m), the reference's
``shard_hint(logits, "batch", None, "model")``) and a distributed
cross-entropy (the log-sum-exp's max and sum all-reduced over "model",
the gold logit from the rank that owns it), for the MTP term and the
vision slice too.  Every layer kind splits (GQA, MLA and Mamba-2 by
heads, GQA heads that ``m`` does not divide unevenly, the MLP by
columns, the MoE by experts); a layer whose FFN ``m`` does not divide
runs whole on every rank of the row.  The decode step's stream is the
one token, whole on every rank: norms run on it, the embedding and the
head are vocab-parallel, the float32 logits gathered over the
vocabulary, and each layer reads the rank's cache shards
(``launch.mesh.cache_specs``).  Each layer (a jamba period: each
sub-layer, the unit its nested checkpoint keeps) reads its parameters
inside ``tensor_parallel.gathered``: their storage shards gathered over
"data" for that layer alone, inside the function remat recomputes, so
the recomputation gathers them again (the reference gathers inside its
``jax.checkpoint``-ed scan body, ``repro/nn/transformer.py:207-219``);
the embedding, ``final_norm``, the head and the MTP head are gathered
where they are used, the head after the last layer.

A jamba period (``JambaPeriod``, one "layer" of the ``jamba_period``
group) holds ``attn_period`` pre-norm sub-layers ``sub0`` ...: sub-layer i
mixes with GQA attention iff ``i == attn_period // 2`` (else Mamba-2) and
its FFN is MoE iff ``i % moe_every == 1`` (else the MLP).  The
reference's ``fold_in(kk, 7)`` key of a sub-layer's FFN has no
counterpart: the port draws every parameter from one generator (the same
distributions, not the same bits).

deepseek v2/v3 run ``mla_dense`` layers (MLA attention, MLP) for the first
``dense_layers`` and ``mla_moe`` layers (MLA, MoE with a shared-expert MLP
``e_ff · max(1, n_shared_experts)`` wide) after them; MLA never takes the
flash hook.  An encoder-only model (hubert) attends non-causally, which
goes to ``_sdpa`` whatever the hook.  The audio frontend is the
``front_proj`` (d, d) of precomputed frame embeddings; the vision
frontend puts precomputed patch embeddings in the first ``n_patches``
slots, before the text, with positions 0 .. S-1 over the whole sequence,
and the loss counts only the text positions.  deepseek-v3's MTP head
(``mtp_norm``, ``mtp_proj`` (2d, d)) adds ``MTP_WEIGHT`` times the CE of
``[norm(h_t); emb(label_t)]`` against the label one further on.  Decode
feeds text tokens only (the reference's), absorbed MLA by default.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import ArchConfig
from ..device import resolve_device
from ..launch import tensor_parallel as tp
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (COMPUTE_DTYPE, apply_norm, dense_init,
                     embed, embedding_init, matmul, mlp, mlp_init, norm_init,
                     param)

__all__ = ["Group", "layer_groups", "Block", "MambaLayer", "JambaLayer",
           "JambaPeriod", "LM", "MTP_WEIGHT",
           "init_params", "abstract_params", "forward", "loss_fn", "init_cache",
           "abstract_cache", "decode_step", "prefill_step"]


@dataclasses.dataclass(frozen=True)
class Group:
    kind: str   # block | mla_dense | mla_moe | mamba | jamba_period
    count: int


def layer_groups(cfg: ArchConfig) -> list[Group]:
    if cfg.family == "ssm":
        return [Group("mamba", cfg.n_layers)]
    if cfg.attn_period:  # jamba: periods of (period - 1) mamba + 1 attention
        assert cfg.n_layers % cfg.attn_period == 0
        return [Group("jamba_period", cfg.n_layers // cfg.attn_period)]
    if cfg.mla:
        gs = []
        if cfg.dense_layers:
            gs.append(Group("mla_dense", min(cfg.dense_layers, cfg.n_layers)))
        if cfg.n_layers - cfg.dense_layers > 0:
            gs.append(Group("mla_moe", cfg.n_layers - cfg.dense_layers))
        return gs
    return [Group("block", cfg.n_layers)]


def _ffn_init(gen, cfg: ArchConfig, use_moe: bool, device=None):
    if use_moe:
        e_ff = cfg.moe_d_ff or cfg.d_ff
        return moe_mod.moe_init(gen, cfg.d_model, e_ff, cfg.n_experts,
                                cfg.gated_mlp, cfg.n_shared_experts,
                                e_ff * max(1, cfg.n_shared_experts), device)
    return mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)


class Block(nn.Module):
    """A pre-norm attention + FFN layer: GQA + MLP (``block``), MLA + MLP
    (``mla_dense``) or MLA + MoE (``mla_moe``)."""

    def __init__(self, cfg: ArchConfig, device=None, gen=None,
                 kind: str = "block"):
        super().__init__()
        if kind not in ("block", "mla_dense", "mla_moe"):
            raise ValueError(kind)
        d = cfg.d_model
        self.norm1 = norm_init(cfg.norm, d, device)
        self.norm2 = norm_init(cfg.norm, d, device)
        self.attn = attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, device) if kind == "block" \
            else attn.mla_init(gen, cfg, device)
        self.ffn = _ffn_init(gen, cfg, kind == "mla_moe", device)


class MambaLayer(nn.Module):
    """A pre-norm Mamba-2 layer."""

    def __init__(self, cfg: ArchConfig, device=None, gen=None):
        super().__init__()
        self.norm1 = norm_init(cfg.norm, cfg.d_model, device)
        self.mamba = ssm_mod.mamba2_init(
            gen, cfg.d_model, cfg.mamba_expand, cfg.mamba_head_dim,
            cfg.ssm_state, cfg.mamba_d_conv, device)


class JambaLayer(nn.Module):
    """A jamba sub-layer: pre-norm GQA attention or Mamba-2, then a
    pre-norm MLP or MoE FFN."""

    def __init__(self, cfg: ArchConfig, is_attn: bool, use_moe: bool,
                 device=None, gen=None):
        super().__init__()
        d = cfg.d_model
        self.is_attn = is_attn
        self.norm1 = norm_init(cfg.norm, d, device)
        self.norm2 = norm_init(cfg.norm, d, device)
        if is_attn:
            self.attn = attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, device)
        else:
            self.mamba = ssm_mod.mamba2_init(
                gen, d, cfg.mamba_expand, cfg.mamba_head_dim, cfg.ssm_state,
                cfg.mamba_d_conv, device)
        self.ffn = _ffn_init(gen, cfg, use_moe, device)


class JambaPeriod(nn.Module):
    """One period of the jamba interleave: sub-layers ``sub0`` ...
    ``sub{attn_period - 1}``, its children in that order."""

    def __init__(self, cfg: ArchConfig, device=None, gen=None):
        super().__init__()
        per = cfg.attn_period
        for i in range(per):
            self.add_module(f"sub{i}", JambaLayer(
                cfg, i == per // 2, cfg.moe and i % cfg.moe_every == 1,
                device, gen))


def _layer_init(gen, cfg: ArchConfig, kind: str, device=None) -> nn.Module:
    if kind == "mamba":
        return MambaLayer(cfg, device, gen)
    if kind == "jamba_period":
        return JambaPeriod(cfg, device, gen)
    return Block(cfg, device, gen, kind)


class LM(nn.Module):
    """The parameters of one model: embedding, layers in order, final norm,
    (untied) head, and where the config has them the audio ``front_proj``
    and the MTP head's ``mtp_norm`` and ``mtp_proj``.  ``kinds[i]`` is
    layer i's group kind."""

    def __init__(self, cfg: ArchConfig, device=None, gen=None):
        super().__init__()
        d = cfg.d_model
        self.embed = param(embedding_init(gen, cfg.vocab, d, device))
        self.final_norm = norm_init(cfg.norm, d, device)
        self.head = None if cfg.tie_embeddings else \
            param(dense_init(gen, d, cfg.vocab, device))
        self.front_proj = param(dense_init(gen, d, d, device)) \
            if cfg.frontend == "audio" else None
        self.mtp_norm = norm_init(cfg.norm, d, device) if cfg.mtp else None
        self.mtp_proj = param(dense_init(gen, 2 * d, d, device)) \
            if cfg.mtp else None
        self.kinds = [g.kind for g in layer_groups(cfg)
                      for _ in range(g.count)]
        self.layers = nn.ModuleList(_layer_init(gen, cfg, kind, device)
                                    for kind in self.kinds)


def abstract_params(cfg: ArchConfig) -> LM:
    """The model's parameters on ``meta``: shapes and dtypes, no storage
    (the reference's ``abstract_params``, for the dry run)."""
    return LM(cfg, device="meta")


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    """Random parameters with the reference's distributions (uniform
    ±1/sqrt(d_in) weights, N(0, 0.02²) embedding, N(0, 0.1²) conv taps,
    unit norms), drawn by a ``torch.Generator`` on ``device`` from
    ``seed``: not the reference's bits."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, device, gen)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _ffn_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if isinstance(p, moe_mod.MoE):
        return moe_mod.moe_ffn(p, x, top_k=cfg.experts_per_tok, act=cfg.act,
                               gated=cfg.gated_mlp)
    return mlp(p, x, cfg.act, cfg.gated_mlp)


def _norm(cfg: ArchConfig, g, x: torch.Tensor) -> torch.Tensor:
    """A norm of the stream (on its slice under a tensor-parallel plan,
    the weight's gradient summed over "model")."""
    return apply_norm(cfg.norm, tp.on_shard(g), x)


def _remat(cfg: ArchConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled() \
        and not moe_mod.routing_hooked()


def _checkpointed(fn, *args):
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _jamba_sub(lp, h: torch.Tensor, cfg: ArchConfig, flash_impl=None):
    with tp.gathered(lp):
        hin = _norm(cfg, lp.norm1, h)
        if lp.is_attn:
            y, _ = attn.gqa_prefill(lp.attn, hin, cfg, flash_impl=flash_impl)
        else:
            y, _ = ssm_mod.ssd_prefill(lp.mamba, hin, cfg)
        h = h + y
        return h + _ffn_apply(lp.ffn, _norm(cfg, lp.norm2, h), cfg)


def _block_fwd(p, h: torch.Tensor, cfg: ArchConfig, kind: str,
               flash_impl=None) -> torch.Tensor:
    """One layer, prefill mode, its parameters gathered for it. h:
    (B,S,d)."""
    if kind == "jamba_period":
        remat = _remat(cfg)          # nested: sub-layer boundaries only
        for lp in p.children():
            h = _checkpointed(_jamba_sub, lp, h, cfg, flash_impl) if remat \
                else _jamba_sub(lp, h, cfg, flash_impl)
        return h
    with tp.gathered(p):
        if kind == "mamba":
            y, _ = ssm_mod.ssd_prefill(p.mamba, _norm(cfg, p.norm1, h), cfg)
            return h + y
        hin = _norm(cfg, p.norm1, h)
        if kind == "block":
            y, _ = attn.gqa_prefill(p.attn, hin, cfg,
                                    causal=not cfg.encoder_only,
                                    flash_impl=flash_impl)
        else:                             # MLA: _sdpa, never the hook
            y, _ = attn.mla_prefill(p.attn, hin, cfg)
        h = h + y
        return h + _ffn_apply(p.ffn, _norm(cfg, p.norm2, h), cfg)


def _embed_stream(params: LM, tokens: torch.Tensor,
                  lead: torch.Tensor | None = None) -> torch.Tensor:
    """The embedded tokens after ``lead`` (B, n, d) as the stream: under
    a tensor-parallel plan its sequence slice, from the rank's vocabulary
    rows summed over "model" where the vocabulary splits."""
    if tp.current() is None:
        text = embed(params.embed, tokens)
        return text if lead is None else torch.cat([lead, text], dim=1)
    if not tp.split(params.embed, 0):              # every rank the same
        text = embed(tp.whole(params.embed, False), tokens)
        h = text if lead is None else torch.cat([lead, text], dim=1)
        return tp.leave_whole(h)
    st = tp.current()
    vl = params.embed.shape[0]
    idx = tokens.long() - st.j * vl
    own = (idx >= 0) & (idx < vl)
    part = F.embedding(idx.clamp(0, vl - 1), params.embed) * own[..., None]
    if lead is not None:                            # once over the ranks
        lead = lead.float() if st.j == 0 else lead.new_zeros(
            lead.shape, dtype=part.dtype)
        part = torch.cat([lead, part], dim=1)
    return tp.leave(part, COMPUTE_DTYPE)


def _embed_inputs(params: LM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Audio: ``front_proj`` of "frames" (B, S, d); vision: "patch_embeds"
    (B, n_patches, d) then the embedded "tokens"; else the tokens.  The
    stream's slice under a tensor-parallel plan."""
    if cfg.frontend == "audio":
        frames = batch["frames"].to(COMPUTE_DTYPE)
        if tp.sliced():
            frames = tp.scatter_seq(frames)
        return matmul(frames, tp.whole(params.front_proj, tp.sliced()))
    lead = batch["patch_embeds"].to(COMPUTE_DTYPE) \
        if cfg.frontend == "vision" else None
    return _embed_stream(params, batch["tokens"], lead)


def _vocab_split(params: LM) -> bool:
    """Whether the head's columns are this rank's vocabulary slice."""
    return tp.split(params.embed, 0) if params.head is None \
        else tp.split(params.head, 1)


def _head(params: LM) -> torch.Tensor:
    return params.embed.T if params.head is None else params.head


def _head_leaves(params: LM, *more: str) -> tuple:
    """The names of the head's leaf (the embedding where tied) and
    ``more``, for ``tensor_parallel.gathered``."""
    return ("embed" if params.head is None else "head",) + more


def _logits(params: LM, h: torch.Tensor) -> torch.Tensor:
    """Logits of the stream: (B,S,V); under a tensor-parallel plan the
    whole sequence's, (B,S,V/m) where the vocabulary splits."""
    if tp.current() is None:
        return matmul(h, _head(params))
    if _vocab_split(params):
        return matmul(tp.enter(h), _head(params))
    leaf = params.embed if params.head is None else params.head
    head = tp.whole(leaf, False)
    return matmul(tp.enter_whole(h),
                  head.T if params.head is None else head)


def forward(params: LM, batch: dict, cfg: ArchConfig, flash_impl=None,
            return_hidden: bool = False):
    """Full-sequence forward -> logits (B,S,V) in the compute dtype (and
    the final-normed hidden states (B,S,d) with ``return_hidden``); under
    a tensor-parallel plan (B,S,V/m) where the vocabulary splits, and the
    hidden states' sequence slice."""
    with tp.gathered(params, "front_proj" if cfg.frontend == "audio"
                     else "embed"):
        h = _embed_inputs(params, batch, cfg)
    remat = _remat(cfg)
    for lp, kind in zip(params.layers, params.kinds):
        h = _checkpointed(_block_fwd, lp, h, cfg, kind, flash_impl) \
            if remat else _block_fwd(lp, h, cfg, kind, flash_impl)
    with tp.gathered(params, *_head_leaves(params, "final_norm")):
        h = _norm(cfg, params.final_norm, h)
        logits = _logits(params, h)
    return (logits, h) if return_hidden else logits


def _ce(logits: torch.Tensor, labels: torch.Tensor,
        vocab_split: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over labels >= 0; with
    ``vocab_split`` ``logits`` are this rank's vocabulary slice."""
    logits = logits.float()
    if vocab_split:
        st = tp.current()
        vl = logits.shape[-1]
        mx = tp.max_over_model(logits.amax(-1))
        lse = mx + torch.log(tp.reduce_from_model(
            torch.exp(logits - mx[..., None]).sum(-1)))
        idx = labels.long() - st.j * vl
        own = (idx >= 0) & (idx < vl)
        gold = logits.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
        gold = tp.reduce_from_model(torch.where(own, gold, 0.0))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[
            ..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum() / mask.sum().clamp(min=1)


MTP_WEIGHT = 0.3


def loss_fn(params: LM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Training loss of ``batch``: "labels" (B, S_text) beside the model's
    inputs ("tokens", and "frames" or "patch_embeds" for a frontend)."""
    labels = batch["labels"]
    vs = _vocab_split(params)
    if cfg.mtp:
        logits, h = forward(params, batch, cfg, return_hidden=True)
        with tp.gathered(params, "embed"):
            lab_emb = _embed_stream(params, labels.clamp(min=0))
        with tp.gathered(params, *_head_leaves(params, "mtp_norm",
                                               "mtp_proj")):
            h2 = torch.cat([_norm(cfg, params.mtp_norm, h)
                            .to(COMPUTE_DTYPE), lab_emb], dim=-1)
            h2 = matmul(h2, tp.whole(params.mtp_proj, tp.sliced()))
            logits2 = _logits(params, h2)
        labels2 = torch.cat([labels[:, 1:],
                             torch.full_like(labels[:, :1], -1)], dim=-1)
        return _ce(logits, labels, vs) \
            + MTP_WEIGHT * _ce(logits2, labels2, vs)
    logits = forward(params, batch, cfg)
    if cfg.frontend == "vision":      # the loss counts the text positions
        logits = logits[:, cfg.n_patches:]
    return _ce(logits, labels, vs)


# ---------------------------------------------------------------------------
# Decode path (KV / state caches)
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                 device=None) -> dict:
    if kind == "block":
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    if kind in ("mla_dense", "mla_moe"):
        return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                    dtype=COMPUTE_DTYPE, device=device),
                "k_rope": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                                      dtype=COMPUTE_DTYPE, device=device)}
    if kind == "mamba":
        di = cfg.mamba_expand * cfg.d_model
        h = di // cfg.mamba_head_dim
        return {"state": torch.zeros((batch, h, cfg.mamba_head_dim,
                                      cfg.ssm_state), dtype=torch.float32,
                                     device=device),
                "conv": torch.zeros((batch, cfg.mamba_d_conv - 1,
                                     di + 2 * cfg.ssm_state),
                                    dtype=COMPUTE_DTYPE, device=device)}
    if kind == "jamba_period":
        per = cfg.attn_period
        return {f"sub{i}": _layer_cache(cfg, "block" if i == per // 2
                                        else "mamba", batch, max_seq, device)
                for i in range(per)}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """One cache dict per layer, in layer order."""
    device = resolve_device(device)
    return [_layer_cache(cfg, g.kind, batch, max_seq, device)
            for g in layer_groups(cfg) for _ in range(g.count)]


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> list[dict]:
    """:func:`init_cache` on ``meta`` (the reference's
    ``abstract_cache``)."""
    return [_layer_cache(cfg, g.kind, batch, max_seq, "meta")
            for g in layer_groups(cfg) for _ in range(g.count)]


def _block_decode(p, c: dict, h: torch.Tensor, pos: int, cfg: ArchConfig,
                  kind: str, mla_absorbed: bool = True):
    """One layer's decode step, its parameters (a jamba sub-layer's)
    gathered for it."""
    if kind == "jamba_period":
        c2 = {}
        for i, lp in enumerate(p.children()):
            lc = c[f"sub{i}"]
            with tp.gathered(lp):
                hin = apply_norm(cfg.norm, lp.norm1, h)
                if lp.is_attn:
                    y, c2[f"sub{i}"] = attn.gqa_decode(lp.attn, hin, lc, pos,
                                                       cfg)
                else:
                    y, c2[f"sub{i}"] = ssm_mod.ssd_decode(lp.mamba, hin, lc,
                                                          cfg)
                h = h + y
                h = h + _ffn_apply(lp.ffn,
                                   apply_norm(cfg.norm, lp.norm2, h), cfg)
        return h, c2
    with tp.gathered(p):
        if kind == "mamba":
            y, c2 = ssm_mod.ssd_decode(
                p.mamba, apply_norm(cfg.norm, p.norm1, h), c, cfg)
            return h + y, c2
        hin = apply_norm(cfg.norm, p.norm1, h)
        if kind == "block":
            y, c2 = attn.gqa_decode(p.attn, hin, c, pos, cfg)
        else:
            fn = attn.mla_decode_absorbed if mla_absorbed \
                else attn.mla_decode
            y, c2 = fn(p.attn, hin, c, pos, cfg)
        h = h + y
        return h + _ffn_apply(p.ffn, apply_norm(cfg.norm, p.norm2, h),
                              cfg), c2


def _decode_logits(params: LM, h: torch.Tensor) -> torch.Tensor:
    """float32 logits (B,1,V) of the final-normed token; under a
    tensor-parallel plan the rank's vocabulary columns gathered over
    "model" where the vocabulary splits."""
    if tp.current() is None:
        return h.float() @ _head(params).float()
    if _vocab_split(params):
        return tp.gather_model(h.float() @ _head(params).float(), 2, False)
    head = tp.whole(params.embed if params.head is None else params.head,
                    False)
    return h.float() @ (head.T if params.head is None else head).float()


def decode_step(params: LM, cache: list[dict], tokens: torch.Tensor,
                pos: int, cfg: ArchConfig, mla_absorbed: bool = True):
    """One serving step: tokens (B,1) at position ``pos`` -> (logits
    (B,1,V) in float32, cache); MLA layers decode absorbed or naive.
    Under a tensor-parallel plan ``cache`` holds this rank's shards
    (``launch.steps.make_decode_step``)."""
    with tp.gathered(params, "embed"):
        h = _embed_stream(params, tokens)
    new_cache = []
    for lp, lc, kind in zip(params.layers, cache, params.kinds):
        h, c2 = _block_decode(lp, lc, h, pos, cfg, kind, mla_absorbed)
        new_cache.append(c2)
    with tp.gathered(params, *_head_leaves(params, "final_norm")):
        h = apply_norm(cfg.norm, params.final_norm, h)
        return _decode_logits(params, h), new_cache


def prefill_step(params: LM, batch: dict, cfg: ArchConfig,
                 flash_impl=None) -> torch.Tensor:
    """Prefill: forward over the prompt, last-position logits (B,V) (under
    a tensor-parallel plan gathered over the vocabulary)."""
    logits = forward(params, batch, cfg, flash_impl)[:, -1]
    return tp.gather_model(logits, 1, False) if _vocab_split(params) \
        else logits
