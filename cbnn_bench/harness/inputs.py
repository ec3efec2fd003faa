"""A run's weights and images, made on the device from ``--seed``.

Weights follow the system's parameter layout (``l{i}_w`` / ``l{i}_dw`` /
``l{i}_pw`` / ``l{i}_b`` and BN's ``l{i}_g`` / ``_beta`` / ``_mu`` /
``_var``), He-normal from one draw.  BN statistics are calibrated on the
run's images, as a trained net's running statistics would be, so
every activation sits at a sensible scale.

A configuration with an ``init.grid`` (the Sign nets) puts the images and
every linear layer that feeds a Sign on a coarse binary grid, and places
each BN-folded Sign threshold half a grid step from every value its input
can take.  The protocol's truncation errs by a few units of 2^-frac a
layer; the grid's half step is wider than that bound, so no Sign input can
cross its threshold by rounding and the served logits must equal the
reference's exactly.  A configuration without one (the ReLU nets) uses
real-valued weights, and its logits differ from the reference's by the
truncation's error alone.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..reference import forward as ref

__all__ = ["make_images", "make_params"]


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) & ((1 << 63) - 1))
    return g


def make_images(cfg: dict, batch: int, distinct: int, seed: int,
                device) -> torch.Tensor:
    """(distinct, batch, H, W, C) float32 images on a 2^-image_bits grid in
    [-1, 1), one draw."""
    bits = cfg["init"]["image_bits"]
    g = generator(seed, device, 1)
    q = torch.randint(-(1 << bits), 1 << bits,
                      (distinct, batch, *cfg["input_shape"]), generator=g,
                      device=device, dtype=torch.int32)
    return q.float() / float(1 << bits)


def _grid_round(w: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.round(w * float(1 << bits)) / float(1 << bits)


def _leaves(cfg: dict):
    """(name, shape, fan_in) of every linear weight, in layer order."""
    h, w, c = cfg["input_shape"]
    out = []
    for i, l in enumerate(cfg["layers"]):
        kind = l["kind"]
        if kind == "conv":
            out.append((f"l{i}_w", (l["k"], l["k"], c, l["out"]),
                        l["k"] * l["k"] * c))
        elif kind == "sepconv":
            out.append((f"l{i}_dw", (l["k"], l["k"], 1, c), l["k"] * l["k"]))
            out.append((f"l{i}_pw", (1, 1, c, l["out"]), c))
        elif kind == "fc":
            out.append((f"l{i}_w", (c, l["out"]), c))
        if kind in ("conv", "sepconv"):
            k, st, pad = l["k"], l.get("stride", 1), l.get("pad", 0)
            h, w = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
            c = l["out"]
        elif kind == "fc":
            c = l["out"]
        elif kind == "maxpool":
            h, w = h // 2, w // 2
        elif kind == "flatten":
            c, h, w = h * w * c, 1, 1
    return out


def _feeds_sign(layers: list, i: int) -> bool:
    return (i + 2 < len(layers) and layers[i + 1]["kind"] == "bn"
            and layers[i + 2]["kind"] == "act"
            and layers[i + 2]["act"] == "sign")


def make_params(cfg: dict, seed: int, device,
                calib: torch.Tensor) -> dict:
    """The run's parameters on ``device``; ``calib`` (B, H, W, C) are the
    images the BN statistics are calibrated on."""
    layers, init = cfg["layers"], cfg["init"]
    grid = init.get("grid")
    frac, eps = cfg["ring"]["frac"], cfg["bn_eps"]
    leaves = _leaves(cfg)
    g = generator(seed, device, 0)
    total = sum(math.prod(s) for _, s, _ in leaves)
    noise = torch.randn(total, generator=g, device=device)
    params, at = {}, 0
    for name, shape, fan_in in leaves:
        n = math.prod(shape)
        params[name] = noise[at:at + n].reshape(shape) * math.sqrt(2 / fan_in)
        at += n
    # biases and BN parameters from one uniform draw
    widths = [l.get("out", 0) for l in layers]
    n_bias = sum(widths[i] for i, l in enumerate(layers)
                 if l["kind"] in ("conv", "sepconv", "fc"))
    n_bn = 4 * sum(1 for l in layers if l["kind"] == "bn") * max(widths)
    u = torch.rand(n_bias + n_bn, generator=g, device=device)
    ub, un = u[:n_bias], u[n_bias:].reshape(-1, 4, max(widths))

    h = calib.float()
    bits = init["image_bits"] if grid else None   # the activation's grid
    first = True
    bn_at = 0
    i = 0
    while i < len(layers):
        l = layers[i]
        kind = l["kind"]
        if kind in ("conv", "sepconv", "fc"):
            out = l["out"]
            gz = None
            if grid and kind != "fc" and _feeds_sign(layers, i):
                gb = grid["first"] if first else grid["rest"]
                parts = ["dw", "pw"] if kind == "sepconv" else ["w"]
                for j, p in enumerate(parts):
                    w = params[f"l{i}_{p}"]
                    if first and kind == "sepconv" and j == 1:
                        clip = grid["first_pointwise_clip"]
                        w = w.clamp(-clip, clip)
                    params[f"l{i}_{p}"] = _grid_round(w, gb)
                gz = bits + gb * len(parts)
            b = (ub[:out] - 0.5) * 0.2
            ub = ub[out:]
            params[f"l{i}_b"] = b if gz is None else _grid_round(b, gz)
            first = False
            if kind == "fc":
                h = h.reshape(h.shape[0], -1) @ params[f"l{i}_w"]
            elif kind == "sepconv":
                h = ref._conv(h, params[f"l{i}_dw"], l["stride"], l["pad"],
                              groups=h.shape[-1])
                h = ref._conv(h, params[f"l{i}_pw"], 1, 0)
            else:
                h = ref._conv(h, params[f"l{i}_w"], l["stride"], l["pad"])
            h = h + params[f"l{i}_b"]
            if i + 1 < len(layers) and layers[i + 1]["kind"] == "bn":
                h = _calibrate_bn(params, i + 1, h, un[bn_at, :, :out], eps,
                                  gz if _feeds_sign(layers, i) else None,
                                  frac)
                bn_at += 1
                i += 1
            bits = None
        elif kind == "act":
            if l["act"] == "sign":
                h = torch.where(h >= 0, 1.0, -1.0)
                bits = 0 if grid else None
            else:
                h = torch.relu(h)
                bits = None
        elif kind == "maxpool":
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        elif kind == "flatten":
            h = h.reshape(h.shape[0], -1)
        elif kind == "bn":
            raise NotImplementedError("a BN with no linear layer before it")
        i += 1
    return params


def _calibrate_bn(params: dict, i: int, z: torch.Tensor, u: torch.Tensor,
                  eps: float, gz: int | None, frac: int) -> torch.Tensor:
    """Set BN ``i``'s statistics from its input ``z`` and the uniforms
    ``u`` (4, C); returns the BN's output.  With ``gz`` (the input's grid
    bits, a Sign next) the mean is moved so that the folded threshold
    lands half a grid step off the grid."""
    dims = tuple(range(z.ndim - 1))
    mean = z.mean(dims)
    var = z.var(dims, correction=0) + 1e-3
    gamma = 0.5 + u[0]
    beta = 0.4 * (u[1] - 0.5)
    var = var * (0.8 + 0.45 * u[2])
    mu = mean + 0.2 * var.sqrt() * (u[3] - 0.5)
    if gz is not None:
        s = torch.sqrt(var.double() + eps)
        lead = beta.double() * s / gamma.double()
        t_half = (torch.floor((lead - mu.double()) * (1 << gz)) + 0.5) \
            / (1 << gz)
        mu = (lead - t_half).float()
        # the fold as the reference (and the model owner) computes it must
        # land on the half step: the margin argument rests on it
        t32 = ref.sign_threshold(gamma.cpu(), beta.cpu(), mu.cpu(),
                                 var.cpu(), eps)
        if t32 is None or not torch.equal(
                torch.round(t32 * (1 << frac)).double(),
                (t_half * (1 << frac)).cpu()):
            raise RuntimeError(f"BN {i}: a folded Sign threshold is not "
                               f"half a grid step off its input's grid")
    params[f"l{i}_g"] = gamma
    params[f"l{i}_beta"] = beta
    params[f"l{i}_mu"] = mu
    params[f"l{i}_var"] = var
    return (z - mu) * torch.rsqrt(var + eps) * gamma + beta
