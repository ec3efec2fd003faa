"""Causal GQA flash attention (kernel B8): wrapper and plain version.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``) and of
its oracle ``repro/kernels/ref.py::flash_attention_ref``.  It is the
``flash_impl`` of the LM prefill step (``kernels.ops.flash_attention_op``):
one launch per attention layer.

On a CUDA tensor :func:`flash_attention` launches the hand-written kernel
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``) at every sequence
length, ragged ones included, or raises; on a CPU tensor it runs the plain
version.  bfloat16 (the prefill step's dtype) runs on the tensor cores and
needs 16-byte aligned q/k/v (:func:`check_aligned`); float32 runs on the
CUDA cores.  Both are instantiated at head widths 32, 64, 96 and 128
(``HEAD_DIMS``).  Any other width up to 128 runs the same kernel on
zero-padded heads (:func:`pad_heads`: q, k and v padded to the next
instantiated width, the kernel given the true 1/sqrt(hd), the output's
padding sliced off): a zero column adds nothing to q·k, and v's zero
columns give output columns that are dropped.  The reference's Pallas
kernel takes any width (``repro/kernels/flash_attention.py:29,59-61``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_ref", "check_aligned",
           "pad_heads", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 96, 128)     # the kernel's instantiated head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version: q (B,S,H,hd), k/v (B,S,Hkv,hd) -> (B,S,H,hd) in q's
    dtype; softmax attention in float32 over the whole row (GQA), scores
    scaled by ``scale`` (default 1/sqrt(hd))."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qg = (q.float() * scale).reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e9)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of the "
                         f"kernel's instantiated widths {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be float32 or "
                             f"bfloat16 like q, on {q.device}, with a "
                             f"contiguous last dim")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """The bf16 kernel copies rows by 16-byte cp.async: the base must be
    16-byte aligned and every (batch, seq, head) stride a multiple of 8
    elements (a dim of size 1 is never stepped)."""
    bad = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1 and s % 8]
    if t.data_ptr() % 16 or bad:
        raise ValueError(f"flash_attention: bf16 {name} must be 16-byte "
                         f"aligned with strides that are multiples of 8; "
                         f"got strides {t.stride()}, offset "
                         f"{t.data_ptr() % 16} bytes")


def pad_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(q, k, v) zero-padded along the head dim to the next instantiated
    width (themselves where hd is one), and the scores' scale
    1/sqrt(hd) of the true width."""
    hd = q.shape[-1]
    wide = [w for w in HEAD_DIMS if w >= hd]
    if not wide:
        raise ValueError(f"flash_attention: head dim {hd} is wider than the "
                         f"kernel's widest instantiation {HEAD_DIMS[-1]}")
    pad = wide[0] - hd
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return q, k, v, 1.0 / math.sqrt(hd)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    hd = q.shape[-1]
    q, k, v, scale = pad_heads(q, k, v)
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(t, name)
    b, s, h, hp = q.shape
    out = torch.empty((b, s, h, hp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :hd]
    fn = build.library("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, k.shape[2], hp, _DTYPES[q.dtype],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             ctypes.c_float(scale), build.stream_ptr(q.device))
    build.check("flash_attention", err)
    build.LAUNCHES["flash_attention"] += 1
    return out if hp == hd else out[..., :hd].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, q (B,S,H,hd), k/v (B,S,Hkv,hd), read through
    strides; returns a contiguous (B,S,H,hd) in q's dtype."""
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=True)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
