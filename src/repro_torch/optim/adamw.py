"""AdamW / SGD as plain functions over a name -> tensor mapping.

Port of ``repro/optim/adamw.py`` (``OptConfig``, ``_q8`` / ``_dq8`` /
``_qu8`` / ``_dqu8``, ``adamw_init``, ``_schedule``, ``global_norm``,
``adamw_update``, ``sgd_update``).  The reference maps a pytree; here the
parameters are a flat ``{name: tensor}`` mapping walked in sorted name
order (the reference's dict-leaf order), and the state mirrors it:
``{"m": {...}, "v": {...}, "step": int32 0-d tensor}``.  The updates
write the parameters and the state in place and return them; the values
are the reference's.  A gradient that is
``None`` (a leaf the loss does not reach, such as BN running statistics in
training mode) counts as zeros, as the reference's zero cotangent does.
Weight decay applies to every leaf.  The parameters, gradients and
moments may be DTensors of one mesh (``Trainer(mesh=...)``): every
operation here is elementwise or a reduction DTensor carries out.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

__all__ = ["OptConfig", "adamw_init", "global_norm", "adamw_update",
           "sgd_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # "fp32" | "int8": block-quantized moments (bitsandbytes-style, per-row
    # scales over the last axis), 4x less optimizer-state memory
    state_dtype: str = "fp32"


def _q8(x: torch.Tensor) -> dict:
    """Signed per-row int8 quantization: x ~ q * s."""
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return {"q8": torch.round(x / s).to(torch.int8), "s8": s.float()}


def _dq8(d: dict) -> torch.Tensor:
    return d["q8"].float() * d["s8"]


def _qu8(x: torch.Tensor) -> dict:
    """Unsigned per-row uint8 quantization (second moment, x >= 0)."""
    s = x.amax(dim=-1, keepdim=True) / 255.0 + 1e-30
    return {"qu8": torch.round(x / s).to(torch.uint8), "su8": s.float()}


def _dqu8(d: dict) -> torch.Tensor:
    return d["qu8"].float() * d["su8"]


def _zeros(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``p``'s shape and layout (a DTensor parameter's
    moments are DTensors with its placements)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: OptConfig | None = None) -> dict:
    state_dtype = cfg.state_dtype if cfg is not None else "fp32"
    dev = next(iter(params.values())).device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if state_dtype == "int8":
        return {"m": {k: _q8(_zeros(p)) for k, p in params.items()},
                "v": {k: _qu8(_zeros(p)) for k, p in params.items()},
                "step": step}
    return {"m": {k: _zeros(p) for k, p in params.items()},
            "v": {k: _zeros(p) for k, p in params.items()}, "step": step}


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up; ``step`` is the already incremented count."""
    warm = torch.clamp((step + 1).float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(grads: Mapping[str, torch.Tensor | None]) -> torch.Tensor:
    total = None
    for k in sorted(grads):
        g = grads[k]
        if g is None:
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor | None], state: dict,
                 cfg: OptConfig):
    """One AdamW step, in place: each parameter and float32 moment is
    updated in its own storage (an int8 moment is requantized into
    ``state``), as the reference's jitted steps donate both, so a step
    holds one leaf's temporaries at a time.  Returns ``(params, state,
    grad_norm)``."""
    with torch.no_grad():
        step = state["step"] + 1
        lr = _schedule(cfg, step)
        gnorm = global_norm(grads).to(step.device)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        bc1 = 1.0 - torch.pow(cfg.beta1, step.float())
        bc2 = 1.0 - torch.pow(cfg.beta2, step.float())
        for k in sorted(params):
            p, g = params[k], grads.get(k)
            g = _zeros(p) if g is None else g.float() * scale
            if cfg.state_dtype == "int8":
                m = cfg.beta1 * _dq8(state["m"][k]) + (1 - cfg.beta1) * g
                v = cfg.beta2 * _dqu8(state["v"][k]) \
                    + (1 - cfg.beta2) * g * g
                state["m"][k], state["v"][k] = _q8(m), _qu8(v)
            else:   # b·m and (1 - b)·g rounded apart, as b·m + (1 - b)·g
                m = state["m"][k].mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
                v = state["v"][k].mul_(cfg.beta2).add_(
                    (1 - cfg.beta2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
        state["step"] = step
    return params, state, gnorm


def sgd_update(params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor | None], state: dict,
               cfg: OptConfig):
    """One SGD step, in place as :func:`adamw_update`; a leaf with no
    gradient stays as it is."""
    with torch.no_grad():
        step = state["step"] + 1
        lr = _schedule(cfg, step)
        for k, p in params.items():
            if grads.get(k) is not None:
                p.copy_((p.float() - lr * grads[k].float()).to(p.dtype))
        gnorm = global_norm(grads)
        state["step"] = step
    return params, state, gnorm
