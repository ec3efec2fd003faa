"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) blocks.

Port of ``repro/nn/ssm.py`` (``CHUNK``, ``mamba2_init``, ``_split_proj``,
``_causal_conv``, ``ssd_prefill``, ``ssd_decode``).  Prefill is the
chunked scan: within a chunk the SSM in matrix form, across chunks a
(H, hd, N) state carried in float32.  Like the reference, ``ssd_prefill``
runs the chunk math as plain tensor code (``kernels.ssd.ssd_chunked``, the
port of its ``lax.scan`` body), not the B9 kernel.  :func:`ssd_inputs` and
:func:`ssd_output` are its two halves around the scan, so a caller can put
``kernels.ssd.ssd_scan`` (B9) between them.

Under a tensor-parallel plan (``launch.tensor_parallel``) the block
splits by heads: rank j runs heads j·H/m ... on the gathered sequence.
The fused ``w_in`` ([z | x | B | C | dt]) and ``conv_w`` (x, B and C
channels) do not split by heads in storage (the reference's spec cuts
their columns contiguously), so train and prefill take them whole
(gathered, ``w_in`` in bf16 as its product takes it, their gradient
reduce-scattered back) and cut out the rank's
z, x and dt columns and the whole B and C, which every head reads (one
group: their gradient sums over the ranks' heads).  ``A_log``, ``D``,
``dt_bias`` and ``norm_g`` are the rank's heads' shards; the gated
RMSNorm's mean over d_inner sums over "model"; ``w_out`` is a row
product whose float32 partial sums leave the layer.  :func:`ssd_inputs`
and :func:`ssd_output` keep the split (the scan between them runs on the
rank's heads).  :func:`ssd_decode` holds the state of the rank's heads
(``cache_specs``: H over "model"); the token's projection is gathered
over "model" (an activation); the conv cache and ``conv_w`` are both
laid out C over "model", so each rank runs the conv on its own channels
and writes its own window back in the spec's layout, and the conv's
output (B x C, an activation) is gathered and cut to the rank's x
channels and the whole B and C; the gated norm gathers the token's
squares (B x d_inner) and averages them in the mesh-less order.
Where ``m`` does not divide the heads, prefill and decode raise.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ssd import ssd_chunked
from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, dense, dense_init,
                     matmul, param, partial_matmul)

__all__ = ["CHUNK", "Mamba2", "mamba2_init", "ssd_inputs", "ssd_output",
           "ssd_prefill", "ssd_decode"]

# default intra-chunk length; ArchConfig.ssd_chunk overrides
CHUNK = 256


class Mamba2(nn.Module):
    def __init__(self, d_model: int, expand: int, head_dim: int,
                 n_state: int, d_conv: int, device=None, gen=None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        f32 = dict(dtype=PARAM_DTYPE, device=device)
        # fused input projection: [z (gate), x, B, C, dt]
        self.w_in = param(dense_init(gen, d_model,
                                     2 * d_inner + 2 * n_state + n_heads,
                                     device))
        conv_shape = (d_conv, d_inner + 2 * n_state)
        self.conv_w = param(torch.empty(conv_shape, **f32) if gen is None
                            else torch.randn(conv_shape, generator=gen,
                                             **f32) * 0.1)
        self.A_log = param(torch.zeros(n_heads, **f32))
        self.D = param(torch.ones(n_heads, **f32))
        self.dt_bias = param(torch.zeros(n_heads, **f32))
        self.norm_g = param(torch.ones(d_inner, **f32))
        self.w_out = param(dense_init(gen, d_inner, d_model, device))


def mamba2_init(gen, d_model: int, expand: int, head_dim: int, n_state: int,
                d_conv: int, device=None) -> Mamba2:
    return Mamba2(d_model, expand, head_dim, n_state, d_conv, device, gen)


def _dims(cfg):
    d_inner = cfg.mamba_expand * cfg.d_model
    return d_inner, cfg.ssm_state, cfg.mamba_head_dim, \
        d_inner // cfg.mamba_head_dim


def _split_proj(proj, d_inner: int, n_state: int, n_heads: int):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n_state]
    dt = proj[..., 2 * d_inner + 2 * n_state:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: xbc (B,S,C), conv_w (K,C)."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * conv_w[i][None, None, :]
              for i in range(k))
    return F.silu(out.float()).to(xbc.dtype)


def _rank_ranges(cfg, j: int, m: int):
    """Rank j's columns of the fused projection (z, x, B and C, dt of
    heads j·H/m ...) and its channels of the conv (x, then B and C), as
    [start, stop) ranges."""
    d_inner, n_state, _, h = _dims(cfg)
    dl, hl = d_inner // m, h // m
    x0, bc0 = d_inner + j * dl, 2 * d_inner
    proj = [(j * dl, (j + 1) * dl), (x0, x0 + dl), (bc0, bc0 + 2 * n_state),
            (bc0 + 2 * n_state + j * hl, bc0 + 2 * n_state + (j + 1) * hl)]
    conv = [(j * dl, (j + 1) * dl), (d_inner, d_inner + 2 * n_state)]
    return proj, conv


def _cut(t: torch.Tensor, ranges, dim: int = -1) -> torch.Tensor:
    return torch.cat([t.narrow(dim, a, b - a) for a, b in ranges], dim)


def _splits(cfg, tp) -> bool:
    """Whether the plan's m ranks split the block's heads."""
    return _dims(cfg)[3] % tp.current().m == 0


def _heads(p: Mamba2, cfg, tp):
    """(A_log, D, dt_bias, norm_g) of this rank's heads; the leaves
    themselves where no plan is in use."""
    if tp.current() is None:
        return p.A_log, p.D, p.dt_bias, p.norm_g
    hl = _dims(cfg)[3] // tp.current().m
    return (tp.block(p.A_log, 0, hl), tp.block(p.D, 0, hl),
            tp.block(p.dt_bias, 0, hl),
            tp.block(p.norm_g, 0, hl * cfg.mamba_head_dim))


def ssd_inputs(p: Mamba2, u: torch.Tensor, cfg):
    """u (B,S,d_model) -> (z, x, bmat, cmat, da, dt): the gate (B,S,d_inner)
    and the scan's inputs x (B,S,H,hd), B/C (B,S,N) in the compute dtype,
    da/dt (B,S,H) in float32.  Under a tensor-parallel plan u is the
    stream's sequence slice and the outputs are the whole sequence's for
    this rank's H/m heads (the gate's d_inner/m columns)."""
    from ..launch import tensor_parallel as tp
    d_inner, n_state, hd, h = _dims(cfg)
    a_log, _, dt_bias, _ = _heads(p, cfg, tp)
    if tp.current() is None:
        z, xbc, dt = _split_proj(dense(p, u, "w_in"), d_inner, n_state, h)
        xbc = _causal_conv(xbc, p.conv_w)
    else:
        if not _splits(cfg, tp):
            raise ValueError(f"Mamba-2's {h} heads do not split over "
                             f"{tp.current().m} model ranks")
        st = tp.current()
        d_inner, h = d_inner // st.m, h // st.m
        proj, conv = _rank_ranges(cfg, st.j, st.m)
        u = tp.enter(u)
        zxbc = matmul(u, _cut(tp.whole(p.w_in, True, COMPUTE_DTYPE), proj))
        z, xbc, dt = _split_proj(zxbc, d_inner, n_state, h)
        xbc = _causal_conv(xbc, _cut(tp.whole(p.conv_w, True), conv))
    b, s, _ = u.shape
    x = xbc[..., :d_inner].reshape(b, s, h, hd)
    bmat = xbc[..., d_inner:d_inner + n_state]
    cmat = xbc[..., d_inner + n_state:]
    dt = F.softplus(dt.float() + dt_bias)                            # (B,S,H)
    da = dt * -torch.exp(a_log)                                      # (B,S,H)
    return z, x, bmat, cmat, da, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                d_inner: int, tp, gather: bool = False) -> torch.Tensor:
    """The gated RMSNorm of y (..., d_inner): under a plan y and z are the
    rank's columns and the mean of squares sums over "model": the ranks'
    partial sums reduced, or with ``gather`` (a decode token: B x d_inner
    floats) the squares gathered and averaged in the mesh-less order."""
    y = y * F.silu(z.float())
    sq = y * y
    if tp.current() is None:
        ms = sq.mean(-1, keepdim=True)
    elif gather:
        ms = tp.gather_model(sq, sq.ndim - 1, False).mean(-1, keepdim=True)
    else:
        ms = tp.sum_over_model(sq.sum(-1, keepdim=True)) / d_inner
    return y * torch.rsqrt(ms + 1e-6) * g


def _out(p: Mamba2, y: torch.Tensor, tp) -> torch.Tensor:
    """``w_out`` of the normed y; under a plan a row product on the rank's
    d_inner/m rows, its float32 partial sums leaving the layer."""
    if tp.current() is None:
        return dense(p, y.to(COMPUTE_DTYPE), "w_out")
    w = tp.block(p.w_out, 0, y.shape[-1])
    return tp.leave(partial_matmul(y, w), COMPUTE_DTYPE)


def ssd_output(p: Mamba2, y: torch.Tensor, x: torch.Tensor,
               z: torch.Tensor, cfg) -> torch.Tensor:
    """The scan's y (B,S,H,hd) -> the block's output (B,S,d_model): the D
    skip, the gated RMSNorm, the output projection (under a
    tensor-parallel plan from the rank's heads to the stream's slice)."""
    from ..launch import tensor_parallel as tp
    b, s = y.shape[:2]
    _, d, _, norm_g = _heads(p, cfg, tp)
    y = y.float() + x.float() * d[None, None, :, None]
    y = _gated_norm(y.reshape(b, s, -1), z, norm_g,
                    cfg.mamba_expand * cfg.d_model, tp)
    return _out(p, y, tp)


def ssd_prefill(p: Mamba2, u: torch.Tensor, cfg):
    """u: (B, S, d_model) -> ((B, S, d_model), final ssm state (B,H,hd,N));
    under a tensor-parallel plan u and the output are the stream's
    sequence slices and the state holds the rank's H/m heads (raises
    where ``m`` does not divide them)."""
    z, x, bmat, cmat, da, dt = ssd_inputs(p, u, cfg)
    s = x.shape[1]
    chunk = cfg.ssd_chunk or CHUNK
    pad = (-s) % chunk
    xs = (x, bmat, cmat, da, dt)
    if pad:
        xs = tuple(F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in xs)
    y, final_state = ssd_chunked(*xs, chunk)
    return ssd_output(p, y[:, :s], x, z, cfg), final_state


def ssd_decode(p: Mamba2, u: torch.Tensor, cache: dict, cfg):
    """One-token step. cache: {state: (B,H,hd,N), conv: (B,K-1,C)}; returns
    the output and a new cache.  Under a tensor-parallel plan the state
    holds this rank's H/m heads and the conv cache its C/m channels (or
    all C where m does not divide them)."""
    from ..launch import tensor_parallel as tp
    b = u.shape[0]
    d_inner, n_state, hd, h = _dims(cfg)
    a_log, d, dt_bias, norm_g = _heads(p, cfg, tp)
    if tp.current() is None:
        z, xbc, dt = _split_proj(dense(p, u, "w_in"), d_inner, n_state, h)
        xbc, new_conv = _conv_step(cache["conv"], xbc, p.conv_w)
    else:
        if not _splits(cfg, tp):
            raise ValueError(f"Mamba-2's {h} heads do not split over "
                             f"{tp.current().m} model ranks")
        z, xbc, dt, new_conv = _decode_inputs_tp(p, u, cache["conv"], cfg,
                                                 tp)
    dl = z.shape[-1]
    x = xbc[..., :dl].reshape(b, dl // hd, hd)
    bv = xbc[:, 0, dl:dl + n_state].float()                      # (B,N)
    cv = xbc[:, 0, dl + n_state:].float()
    dtv = F.softplus(dt[:, 0].float() + dt_bias)                 # (B,H)
    decay = torch.exp(dtv * -torch.exp(a_log))                   # (B,H)
    xdt = x.float() * dtv[..., None]                             # (B,H,hd)
    state = cache["state"] * decay[:, :, None, None] \
        + torch.einsum("bhd,bn->bhdn", xdt, bv)
    y = torch.einsum("bhdn,bn->bhd", state, cv)
    y = y + x.float() * d[None, :, None]
    y = _gated_norm(y.reshape(b, 1, dl), z, norm_g, d_inner, tp, gather=True)
    return _out(p, y, tp), {"state": state, "conv": new_conv}


def _conv_step(conv: torch.Tensor, xbc: torch.Tensor, conv_w):
    """The causal conv of one new row ``xbc`` (B,1,C) after the window
    ``conv`` (B,K-1,C): (its activated output (B,1,C), the next window)."""
    conv_in = torch.cat([conv, xbc.to(conv.dtype)], dim=1)
    out = (conv_in * conv_w[None]).sum(dim=1, keepdim=True)
    return F.silu(out.float()).to(COMPUTE_DTYPE), conv_in[:, 1:]


def _decode_inputs_tp(p: Mamba2, u, conv: torch.Tensor, cfg, tp):
    """The decode step's inputs on this rank: its gate columns z, the
    activated conv output of its x channels and the whole B and C, its dt
    columns and its next conv window in the spec's layout.  The token's
    projection is gathered over "model"; each rank runs the conv on its
    own channels of the window (``conv_w`` and the conv cache split alike,
    C over "model") and the outputs are gathered (B x C: an activation,
    neither the cache nor a weight)."""
    st = tp.current()
    d_inner, n_state, _, _ = _dims(cfg)
    proj_r, conv_r = _rank_ranges(cfg, st.j, st.m)
    (proj,) = tp.columns(u, p.w_in)                       # (B,1,C_in) whole
    c_all, cl = d_inner + 2 * n_state, conv.shape[2]
    if cl == c_all:                                       # C whole: no split
        xbc, new_conv = _conv_step(conv, proj[..., d_inner:d_inner + c_all],
                                   tp.whole(p.conv_w, False))
    else:
        c0 = d_inner + st.j * cl
        xbc, new_conv = _conv_step(conv, proj[..., c0:c0 + cl],
                                   tp.block(p.conv_w, 1, cl))
        xbc = tp.gather_model(xbc, 2, False)
    return (_cut(proj, proj_r[:1]), _cut(xbc, conv_r), _cut(proj, proj_r[3:]),
            new_conv)
