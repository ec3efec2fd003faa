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

Under a tensor-parallel plan (``launch.tensor_parallel``) :func:`mlp`
takes the stream's sequence slice and its weights' "model" shards:
``w_up`` / ``w_gate`` on their local columns of the gathered sequence,
``w_down`` on its local rows as float32 partial sums (a bf16 GEMM's
float32 accumulator, as the mesh-less product's before its one
rounding), reduce-scattered over the sequence and rounded to bf16
once.  Where ``d_ff`` does not split, the MLP runs whole.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["COMPUTE_DTYPE", "PARAM_DTYPE", "param", "dense_init", "dense",
           "matmul", "partial_matmul",
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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands in bfloat16."""
    return x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)


def dense(p, x: torch.Tensor, name: str) -> torch.Tensor:
    """``x @ p.<name>`` with both operands in bfloat16."""
    return matmul(x, getattr(p, name))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands, ``a`` (..., K) and ``b`` (K, N),
    accumulated and returned in float32: on the card (and ``meta``) one
    bf16 tensor-core GEMM with a float32 output (``torch.mm(...,
    out_dtype=)``); on the host, where that op has no kernel, the float32
    product of the upcast operands (each product exact in float32)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _PartialMatmul(torch.autograd.Function):
    """``x @ w`` of bf16 operands as a float32 partial sum (its one
    rounding comes after the sum over ranks); backward in bf16, as the
    mesh-less product's (the cotangent is a bf16 value's float32 copy)."""
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).T
                  @ g.reshape(-1, g.shape[-1]))
        return gx, gw


def partial_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum: the bf16 operands' product
    accumulated and returned in float32, for a sum over ranks before the
    one rounding to bf16."""
    return _PartialMatmul.apply(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


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


def _hidden(p, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    up = dense(p, x, "w_up")
    if gated:
        return act_fn(act)(dense(p, x, "w_gate")) * up
    return act_fn(act)(up)


def _mlp(p, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    return dense(p, _hidden(p, x, act, gated), "w_down")


def mlp(p: MLP, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    from ..launch import tensor_parallel as tp
    if tp.current() is None:
        return _mlp(p, x, act, gated)
    if tp.split(p.w_up, 1) and tp.split(p.w_down, 0) \
            and (not gated or tp.split(p.w_gate, 1)):
        h = _hidden(p, tp.enter(x), act, gated)    # (B, S, d_ff / m)
        return tp.leave(partial_matmul(h, p.w_down), COMPUTE_DTYPE)
    raise ValueError(f"the MLP's {p.w_up.shape[1]} columns do not split "
                     f"over {tp.current().m} model ranks")


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
