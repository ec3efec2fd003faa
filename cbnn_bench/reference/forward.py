"""The plain reference of a served classifier: the network of a
configuration file, evaluated in plain PyTorch on the parameters at the
configuration's fixed-point encoding.

It imports nothing of the system under test.  It folds each BN itself, as
the paper's model owner does (eq. 8: a BN before a Sign with a positive
scale becomes a per-channel threshold; eqs. 10-11: any other BN after a
linear layer folds into its weight and bias), in float32, then encodes
every weight, bias, threshold and the input to the ring's fixed point,
``round(v * 2^frac) / 2^frac``.  From there it computes exactly (float64):
linear layers with no truncation, Sign as ``z + t >= 0``, ReLU, 2x2
maxpool, and the last fc.  The secure protocol computes the same function
up to its truncation error, a few units of 2^-frac a truncation.

``forward(..., dtype=torch.bfloat16)`` is the control: the same network
with every tensor rounded to bfloat16, the 16-bit format below the
configuration's 32-bit words.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fold", "forward", "sign_threshold", "min_public_limbs"]


def _enc(v: torch.Tensor, frac: int) -> torch.Tensor:
    """float32 -> the fixed-point value, rounded half to even in float32."""
    return torch.round(v.float() * float(1 << frac)) / float(1 << frac)


def sign_threshold(g, beta, mu, var, eps: float):
    """A BN before a Sign as the threshold t with Sign(BN(z)) = Sign(z + t),
    in float32 (paper eq. 8); None unless every scale is positive."""
    s = torch.sqrt(var + eps)
    gp = g / s
    if not bool((gp > 0).all()):
        return None
    bp = beta - g * mu / s
    return bp / gp


def fold(params: dict, layers: list, frac: int, eps: float,
         device="cpu") -> list:
    """The encoded network: one entry a linear layer (``w`` a list of its
    weight parts in the NHWC / HWIO layout, ``b``, ``t`` the Sign
    threshold or None), and ``sign`` / ``relu`` / ``maxpool`` / ``flatten``
    entries.  The folds run in float32 on the CPU."""
    def p(name):
        return params[name].detach().to("cpu", torch.float32)

    ops, i = [], 0
    while i < len(layers):
        l = layers[i]
        kind = l["kind"]
        if kind in ("conv", "sepconv", "fc"):
            w = ([p(f"l{i}_dw"), p(f"l{i}_pw")] if kind == "sepconv"
                 else [p(f"l{i}_w")])
            b = p(f"l{i}_b")
            t = None
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            nxt2 = layers[i + 2] if i + 2 < len(layers) else None
            if nxt is not None and nxt["kind"] == "bn":
                g, beta = p(f"l{i + 1}_g"), p(f"l{i + 1}_beta")
                mu, var = p(f"l{i + 1}_mu"), p(f"l{i + 1}_var")
                if nxt2 is not None and nxt2["kind"] == "act" \
                        and nxt2["act"] == "sign":
                    t = sign_threshold(g, beta, mu, var, eps)
                if t is None:
                    sc = g / torch.sqrt(var + eps)   # eqs. 10-11
                    w[-1] = w[-1] * sc
                    b = beta + (b - mu) * sc
                i += 1
            ops.append({"kind": kind, "k": l.get("k", 1),
                        "stride": l.get("stride", 1), "pad": l.get("pad", 0),
                        "w": [_enc(x, frac).to(device) for x in w],
                        "b": _enc(b, frac).to(device),
                        "t": None if t is None else _enc(t, frac).to(device)})
        elif kind == "act":
            ops.append({"kind": l["act"]})
        elif kind in ("maxpool", "flatten"):
            ops.append({"kind": kind})
        elif kind == "bn":
            raise NotImplementedError("a BN with no linear layer before it")
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        i += 1
    return ops


def _conv(x, w, stride, pad, groups=1):
    """NHWC x, HWIO w -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def forward(ops: list, x: torch.Tensor, frac: int,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Logits (float32) of images ``x`` (B, H, W, C) under the encoded
    network ``ops``; the input is encoded first."""
    def cast(v):
        return v.to(x.device, dtype)

    h = cast(_enc(x, frac))
    t = None
    for op in ops:
        kind = op["kind"]
        if kind in ("conv", "sepconv", "fc"):
            w = [cast(v) for v in op["w"]]
            if kind == "fc":
                h = h @ w[0]
            elif kind == "sepconv":
                h = _conv(h, w[0], op["stride"], op["pad"], groups=h.shape[-1])
                h = _conv(h, w[1], 1, 0)
            else:
                h = _conv(h, w[0], op["stride"], op["pad"])
            h = h + cast(op["b"])
            t = None if op["t"] is None else cast(op["t"])
        elif kind == "sign":
            z = h if t is None else h + t
            h = torch.where(z >= 0, 1.0, -1.0).to(dtype)
            t = None
        elif kind == "relu":
            h = torch.relu(h)
        elif kind == "maxpool":
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        elif kind == "flatten":
            h = h.reshape(h.shape[0], -1)
    return h.float()


def min_public_limbs(w: torch.Tensor, frac: int) -> int:
    """The fewest balanced 8-bit limbs (each in [-128, 127]) that hold
    every word of the 32-bit encoding of ``w`` exactly: the public weight
    products run that many limb passes."""
    cur = torch.round(w.float() * float(1 << frac)).to(torch.int64)
    cur = cur & 0xFFFFFFFF
    n = 0
    for p in range(4):
        lo = cur & 0xFF
        carry = (lo >= 128).to(torch.int64)
        if bool(((lo - 256 * carry) != 0).any()):
            n = p + 1
        cur = (cur >> 8) + carry
    return max(n, 1)
