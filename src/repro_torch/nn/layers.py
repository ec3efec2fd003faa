"""Basic layers and initialisers of the plaintext LM path.

Port of ``repro/nn/layers.py`` (``dense_init``, ``dense``,
``embedding_init``, ``embed``, ``rmsnorm``, ``layernorm``, ``apply_norm``,
``norm_init``, ``act_fn``, ``mlp_init``, ``mlp``, ``rope_freqs``,
``apply_rope``).  Same dtype policy: float32 parameters, bfloat16 matmuls,
float32 norms, softmax and RoPE.  Weights keep the reference's layout,
``(d_in, d_out)`` with ``x @ w``.  Parameters live on ``nn.Module``s (the
reference's pytree leaves become attributes of the same names); an
initialiser given no ``torch.Generator`` allocates without filling, for
loading converted weights (``weights.lm_params_from_numpy``).  Parameters
take no gradient, except inside :func:`trainable` (the train step's).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["COMPUTE_DTYPE", "PARAM_DTYPE", "param", "dense_init", "dense",
           "embedding_init", "embed", "rmsnorm", "LayerNorm", "layernorm",
           "apply_norm", "norm_init", "act_fn", "MLP", "mlp_init", "mlp",
           "rope_freqs", "apply_rope", "trainable"]

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def param(t: torch.Tensor) -> nn.Parameter:
    """An inference parameter (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


@contextlib.contextmanager
def trainable(module: nn.Module):
    """Every parameter of ``module`` takes a gradient inside the block and
    none after it."""
    ps = list(module.parameters())
    for p in ps:
        p.requires_grad_(True)
    try:
        yield ps
    finally:
        for p in ps:
            p.requires_grad_(False)


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    u = torch.rand(shape, generator=gen, dtype=PARAM_DTYPE, device=device)
    return u.mul_(hi - lo).add_(lo)     # in place: no copy of a large stack


def dense_init(gen, d_in: int, d_out: int, device=None) -> torch.Tensor:
    return _uniform(gen, (d_in, d_out), -1.0, 1.0, device) \
        .div_(math.sqrt(d_in))


def dense(p, x: torch.Tensor, name: str) -> torch.Tensor:
    """``x @ p.<name>`` with both operands in bfloat16."""
    return x.to(COMPUTE_DTYPE) @ getattr(p, name).to(COMPUTE_DTYPE)


def embedding_init(gen, vocab: int, d: int, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty((vocab, d), dtype=PARAM_DTYPE, device=device)
    return torch.randn((vocab, d), generator=gen, dtype=PARAM_DTYPE,
                       device=device) * 0.02


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table).to(COMPUTE_DTYPE)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """The reference's ``{"g", "b"}`` layernorm parameters."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.g = param(torch.ones(d, dtype=PARAM_DTYPE, device=device))
        self.b = param(torch.zeros(d, dtype=PARAM_DTYPE, device=device))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.g.float() + p.b.float()).to(x.dtype)


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def norm_init(kind: str, d: int, device=None):
    if kind == "rmsnorm":
        return param(torch.ones(d, dtype=PARAM_DTYPE, device=device))
    return LayerNorm(d, device)


# -- activations -------------------------------------------------------------

def act_fn(kind: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax default
            "relu": F.relu,
            "sq_relu": lambda x: torch.square(F.relu(x))}[kind]


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, gated: bool, device=None,
                 gen=None):
        super().__init__()
        self.w_up = param(dense_init(gen, d, d_ff, device))
        self.w_down = param(dense_init(gen, d_ff, d, device))
        self.w_gate = param(dense_init(gen, d, d_ff, device)) if gated \
            else None


def mlp_init(gen, d: int, d_ff: int, gated: bool, device=None) -> MLP:
    return MLP(d, d_ff, gated, device, gen)


def mlp(p: MLP, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    up = dense(p, x, "w_up")
    if gated:
        h = act_fn(act)(dense(p, x, "w_gate")) * up
    else:
        h = act_fn(act)(up)
    return dense(p, h, "w_down")


# -- RoPE --------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs       # (..,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
