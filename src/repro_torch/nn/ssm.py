"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) blocks.

Port of ``repro/nn/ssm.py`` (``CHUNK``, ``mamba2_init``, ``_split_proj``,
``_causal_conv``, ``ssd_prefill``, ``ssd_decode``).  Prefill is the
chunked scan: within a chunk the SSM in matrix form, across chunks a
(H, hd, N) state carried in float32.  Like the reference, ``ssd_prefill``
runs the chunk math as plain tensor code (``kernels.ssd.ssd_chunked``, the
port of its ``lax.scan`` body), not the B9 kernel.  :func:`ssd_inputs` and
:func:`ssd_output` are its two halves around the scan, so a caller can put
``kernels.ssd.ssd_scan`` (B9) between them.  Under a tensor-parallel plan
(``launch.tensor_parallel``) ``ssd_prefill`` runs whole: its weights
gathered over "model", the whole sequence on every rank of the row.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ssd import ssd_chunked
from .layers import COMPUTE_DTYPE, PARAM_DTYPE, dense, dense_init, param

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


def ssd_inputs(p: Mamba2, u: torch.Tensor, cfg):
    """u (B,S,d_model) -> (z, x, bmat, cmat, da, dt): the gate (B,S,d_inner)
    and the scan's inputs x (B,S,H,hd), B/C (B,S,N) in the compute dtype,
    da/dt (B,S,H) in float32."""
    b, s, _ = u.shape
    d_inner, n_state, hd, h = _dims(cfg)
    z, xbc, dt = _split_proj(dense(p, u, "w_in"), d_inner, n_state, h)
    xbc = _causal_conv(xbc, p.conv_w)
    x = xbc[..., :d_inner].reshape(b, s, h, hd)
    bmat = xbc[..., d_inner:d_inner + n_state]
    cmat = xbc[..., d_inner + n_state:]
    dt = F.softplus(dt.float() + p.dt_bias)                          # (B,S,H)
    da = dt * -torch.exp(p.A_log)                                    # (B,S,H)
    return z, x, bmat, cmat, da, dt


def ssd_output(p: Mamba2, y: torch.Tensor, x: torch.Tensor,
               z: torch.Tensor, cfg) -> torch.Tensor:
    """The scan's y (B,S,H,hd) -> the block's output (B,S,d_model): the D
    skip, the gated RMSNorm, the output projection."""
    b, s = y.shape[:2]
    d_inner = cfg.mamba_expand * cfg.d_model
    y = y.float() + x.float() * p.D[None, None, :, None]
    y = y.reshape(b, s, d_inner) * F.silu(z.float())
    ms = (y * y).mean(-1, keepdim=True)
    y = y * torch.rsqrt(ms + 1e-6) * p.norm_g
    return dense(p, y.to(COMPUTE_DTYPE), "w_out")


def ssd_prefill(p: Mamba2, u: torch.Tensor, cfg):
    """u: (B, S, d_model) -> ((B, S, d_model), final ssm state (B,H,hd,N))."""
    from ..launch import tensor_parallel as tp
    if tp.current() is not None:
        return tp.replicated(_ssd_prefill, p, u, cfg)
    return _ssd_prefill(p, u, cfg)


def _ssd_prefill(p, u: torch.Tensor, cfg):
    s = u.shape[1]
    z, x, bmat, cmat, da, dt = ssd_inputs(p, u, cfg)
    chunk = cfg.ssd_chunk or CHUNK
    pad = (-s) % chunk
    xs = (x, bmat, cmat, da, dt)
    if pad:
        xs = tuple(F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in xs)
    y, final_state = ssd_chunked(*xs, chunk)
    return ssd_output(p, y[:, :s], x, z, cfg), final_state


def ssd_decode(p: Mamba2, u: torch.Tensor, cache: dict, cfg):
    """One-token step. cache: {state: (B,H,hd,N), conv: (B,K-1,C)}; returns
    the output and a new cache."""
    b = u.shape[0]
    d_inner, n_state, hd, h = _dims(cfg)
    z, xbc, dt = _split_proj(dense(p, u, "w_in"), d_inner, n_state, h)
    conv_in = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = (conv_in * p.conv_w[None]).sum(dim=1, keepdim=True)
    xbc = F.silu(conv_out.float()).to(COMPUTE_DTYPE)
    new_conv = conv_in[:, 1:]

    x = xbc[..., :d_inner].reshape(b, h, hd)
    bv = xbc[:, 0, d_inner:d_inner + n_state].float()            # (B,N)
    cv = xbc[:, 0, d_inner + n_state:].float()
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias)               # (B,H)
    decay = torch.exp(dtv * -torch.exp(p.A_log))                 # (B,H)
    xdt = x.float() * dtv[..., None]                             # (B,H,hd)
    state = cache["state"] * decay[:, :, None, None] \
        + torch.einsum("bhd,bn->bhdn", xdt, bv)
    y = torch.einsum("bhdn,bn->bhd", state, cv)
    y = y + x.float() * p.D[None, :, None]
    y = y.reshape(b, 1, d_inner) * F.silu(z.float())
    ms = (y * y).mean(-1, keepdim=True)
    y = y * torch.rsqrt(ms + 1e-6) * p.norm_g
    return dense(p, y.to(COMPUTE_DTYPE), "w_out"), \
        {"state": state, "conv": new_conv}
