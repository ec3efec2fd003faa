"""Step functions of the plaintext LM path (prefill, decode).

Port of ``repro/launch/steps.py`` (``make_prefill_step``,
``make_decode_step``).  The train step and the abstract input specs of the
dry-run path wait for the training slice (ROADMAP.md §A item 8).  The
steps run without autograd.
"""
from __future__ import annotations

import torch

from ..configs import ArchConfig
from ..nn import transformer as tfm

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ArchConfig, flash_impl=None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits;
    ``flash_impl`` (e.g. ``kernels.ops.flash_attention_op``) takes the
    causal attention of every layer."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return tfm.prefill_step(params, batch, cfg, flash_impl)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, cache, {"tokens": (B,1), "pos": int}) ->
    (logits (B,1,V), cache)``."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return tfm.decode_step(params, cache, batch["tokens"], batch["pos"],
                               cfg)
    return serve_step
