"""Step functions of the plaintext LM path (train, prefill, decode).

Port of ``repro/launch/steps.py`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``).  The train step takes the
gradient of ``nn.transformer.loss_fn`` with respect to every parameter of
the ``LM`` module (``nn.layers.trainable`` turns gradients on for the step
only) and applies ``optim.adamw_update`` in place.  The prefill and decode
steps run without autograd.  The abstract input specs of the dry-run path
(``input_specs``, ``abstract_state``) wait for the launchers of ROADMAP.md
§A item 8.
"""
from __future__ import annotations

import torch

from ..configs import ArchConfig
from ..nn import transformer as tfm
from ..nn.layers import trainable
from ..optim import OptConfig, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``params`` is the ``LM`` module, updated in
    place and returned; ``opt_state`` is ``optim.adamw_init`` of
    ``dict(params.named_parameters())``; ``batch`` holds "labels" and the
    model's inputs (``nn.transformer.loss_fn``: "tokens", and "frames" or
    "patch_embeds" for a frontend).  The metrics are 0-d device
    tensors."""
    opt_cfg = opt_cfg or OptConfig()

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with trainable(params) as leaves:
            loss = tfm.loss_fn(params, batch, cfg)
            # hubert's loss never reads its token embedding: None, which
            # adamw_update takes as zeros (the reference's gradient)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        _, opt_state, gnorm = adamw_update(
            named, dict(zip(named, grads)), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, flash_impl=None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits of
    the batch's inputs ("tokens", "frames" or "patch_embeds" + "tokens");
    ``flash_impl`` (e.g. ``kernels.ops.flash_attention_op``) takes the
    causal GQA attention of every layer (never MLA's, nor an encoder's)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return tfm.prefill_step(params, batch, cfg, flash_impl)
    return prefill_step


def make_decode_step(cfg: ArchConfig, mla_absorbed: bool = True):
    """``serve_step(params, cache, {"tokens": (B,1), "pos": int}) ->
    (logits (B,1,V), cache)``; MLA layers decode absorbed (the default)
    or naive."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return tfm.decode_step(params, cache, batch["tokens"], batch["pos"],
                               cfg, mla_absorbed=mla_absorbed)
    return serve_step
