"""Whether the window's answers are correct: every query's opened logits
against the plain reference's logits of the same images.

The number compared is ``logit_gap``: the largest absolute difference of
any served logit from the reference's, over every query of the window, as
a share of the reference logits' root mean square over the query's batch.
Its limit is the configuration's ``check.logit_gap``.  The reference runs
after the window, once the system's state is freed, one distinct image
batch at a time in blocks of rows.
"""
from __future__ import annotations

import math

import torch

from ..reference import forward as ref

__all__ = ["reference_logits", "compare", "ROWS"]

ROWS = 64       # the reference's block of images


def reference_logits(cfg: dict, params: dict, images: torch.Tensor,
                     dtype: torch.dtype = torch.float64) -> list:
    """The reference's logits (on the host) of each distinct batch of
    ``images`` (distinct, B, H, W, C); ``dtype=torch.bfloat16`` is the
    control."""
    frac = cfg["ring"]["frac"]
    ops = ref.fold(params, cfg["layers"], frac, cfg["bn_eps"],
                   device=images.device)
    with torch.no_grad():
        return [torch.cat([ref.forward(ops, x[r:r + ROWS], frac, dtype)
                           for r in range(0, x.shape[0], ROWS)]).cpu()
                for x in images]


def compare(cfg: dict, answers: list, refs: list) -> tuple[dict, int]:
    """({"logit_gap": {"value", "limit"}}, the number of queries over the
    limit) for ``answers`` [(batch index, logits)] against ``refs``.  A
    missing, misshapen or non-finite answer reads as an infinite gap."""
    limit = cfg["check"]["logit_gap"]
    scale = [max(float(r.double().pow(2).mean().sqrt()), 1e-12)
             for r in refs]
    gap, failed = 0.0, 0
    for b, logits in answers:
        want = refs[b]
        if tuple(logits.shape) != tuple(want.shape) \
                or not bool(torch.isfinite(logits).all()):
            g = math.inf
        else:
            g = float((logits.double() - want.double()).abs().max()) \
                / scale[b]
        gap = max(gap, g)
        failed += limit is None or g > limit
    if not answers:
        gap, failed = math.inf, 1
    return {"logit_gap": {"value": gap, "limit": limit}}, failed
