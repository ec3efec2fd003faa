"""Compressed gradient sum over a process group: int8 payloads with
per-row float32 scales.

Port of ``repro/optim/compress.py`` (``_quant_rows``,
``int8_psum``, ``compressed_tree_psum``).  Each rank quantizes its
partial gradient to int8 with a per-row scale (the last axis a row),
all-gathers the (int8, scale) pairs over the group (1 B an element on
the link instead of 4, plus a float32 a row) and sums the dequantized
rows locally, in rank order, so every rank holds the same sum.  The error
is at most one int8 step of each rank's row maximum, summed over the
ranks (the reference's ``tests/test_compress.py`` bound: 2 x max |g| /
127 over two ranks).  The group is a ``torch.distributed`` group (a
``DeviceMesh`` axis's ``get_group(name)``, or None for the default
group); CUDA tensors travel through host copies when the backend is gloo.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

__all__ = ["int8_psum", "compressed_tree_psum"]


def _quant_rows(x: torch.Tensor):
    xf = x.float()
    flat = xf.reshape(-1, x.shape[-1]) if x.ndim > 1 else xf.reshape(1, -1)
    s = flat.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(flat / s).to(torch.int8)
    return q, s


def _all_gather(t: torch.Tensor, group) -> list:
    host = t.device.type == "cuda" \
        and dist.get_backend(group) == dist.Backend.GLOO
    src = t.cpu() if host else t.contiguous()
    bufs = [torch.empty_like(src)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, src, group=group)
    return [b.to(t.device) for b in bufs] if host else bufs


def int8_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, sent as int8 rows and
    per-row scales; every rank returns the same tensor, in ``x``'s shape
    and dtype."""
    q, s = _quant_rows(x)
    total = None
    for qr, sr in zip(_all_gather(q, group), _all_gather(s, group)):
        part = qr.float() * sr
        total = part if total is None else total + part
    return total.reshape(x.shape).to(x.dtype)


def compressed_tree_psum(grads: Mapping[str, torch.Tensor | None],
                         group=None) -> dict:
    """:func:`int8_psum` of every gradient of a ``{name: tensor}`` map, in
    sorted name order (every rank sends in the same order); a ``None``
    gradient stays None."""
    return {k: None if grads[k] is None else int8_psum(grads[k], group)
            for k in sorted(grads)}
