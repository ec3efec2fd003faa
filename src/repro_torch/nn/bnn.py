"""Binarized neural networks (paper §3.1): layer specs, the MnistNet /
CifarNet families, initialisation and the plaintext forward.

Port of ``repro/nn/bnn.py`` (``L``, ``MNIST_NETS``, ``CIFAR_NETS``,
``ALL_NETS``, ``INPUT_SHAPES``, ``sign_ste``, ``init_bnn``, ``bnn_forward``,
``param_count``).  The port keeps its own copy of the specs.  In eval mode
``bnn_forward`` is the plaintext oracle the secure executor is held
against and runs without autograd; ``train=True`` is the training forward
(batch statistics, the clipped straight-through Sign), in the reference's
layout (NHWC activations, HWIO weights).  ``init_bnn`` draws from a
``torch.Generator``, so its weights differ from the reference's;
``weights.params_from_numpy`` carries a reference parameter dict across.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

__all__ = ["L", "MNIST_NETS", "CIFAR_NETS", "ALL_NETS", "INPUT_SHAPES",
           "sign_ste", "init_bnn", "bnn_forward", "param_count"]


@dataclasses.dataclass(frozen=True)
class L:
    """One layer of a sequential net spec, walked by both executors.

    Params are keyed by spec position ``i``: ``l{i}_w``/``l{i}_b`` for
    conv/fc, ``l{i}_dw``/``l{i}_pw``/``l{i}_b`` for sepconv (depthwise
    multiplier 1, HWIO ``(k, k, 1, Cin)``, then a 1×1 pointwise), and
    ``l{i}_g``/``l{i}_beta``/``l{i}_mu``/``l{i}_var`` for bn."""

    kind: str           # conv | sepconv | fc | bn | act | maxpool | flatten
    out: int = 0
    k: int = 3
    stride: int = 1
    pad: int = 0
    act: str = "sign"   # for kind == "act": sign | relu


def _act(spec: str):
    return [L("bn"), L("act", act=spec)]


MNIST_NETS = {
    "MnistNet1": [L("flatten"), L("fc", 128), *_act("sign"),
                  L("fc", 128), *_act("sign"), L("fc", 10)],
    "MnistNet2": [L("conv", 16, k=5, stride=2, pad=2), *_act("sign"),
                  L("flatten"), L("fc", 100), *_act("sign"), L("fc", 10)],
    "MnistNet3": [L("conv", 16, k=5, pad=2), *_act("sign"), L("maxpool"),
                  L("conv", 16, k=5, pad=2), *_act("sign"), L("maxpool"),
                  L("flatten"), L("fc", 100), *_act("sign"), L("fc", 10)],
    "MnistNet3-sep": [L("conv", 16, k=5, pad=2), *_act("sign"), L("maxpool"),
                      L("sepconv", 16, k=5, pad=2), *_act("sign"),
                      L("maxpool"),
                      L("flatten"), L("fc", 100), *_act("sign"), L("fc", 10)],
    "MnistNet4": [L("conv", 32, k=5, pad=2), *_act("relu"), L("maxpool"),
                  L("conv", 64, k=5, pad=2), *_act("relu"), L("maxpool"),
                  L("flatten"), L("fc", 512), *_act("relu"), L("fc", 10)],
}


def _vgg_block(ch, n, sep=False):
    kind = "sepconv" if sep else "conv"
    out = []
    for _ in range(n):
        out += [L(kind, ch, k=3, pad=1), *_act("sign")]
    return out + [L("maxpool")]


CIFAR_NETS = {
    "CifarNet1": [L("conv", 64, k=3, pad=1), *_act("sign"),
                  L("conv", 64, k=3, pad=1), *_act("sign"), L("maxpool"),
                  L("conv", 64, k=3, pad=1), *_act("sign"),
                  L("conv", 64, k=3, pad=1), *_act("sign"), L("maxpool"),
                  L("conv", 64, k=3, pad=1), *_act("sign"),
                  L("conv", 64, k=1), *_act("sign"),
                  L("conv", 16, k=1), *_act("sign"),
                  L("flatten"), L("fc", 10)],
    "CifarNet2": [*_vgg_block(16, 3, sep=True), *_vgg_block(32, 3, sep=True),
                  *_vgg_block(48, 3, sep=True), L("flatten"), L("fc", 10)],
    "CifarNet3": [*_vgg_block(32, 3, sep=True), *_vgg_block(48, 3, sep=True),
                  *_vgg_block(64, 3, sep=True), L("flatten"), L("fc", 10)],
    "CifarNet4": [*_vgg_block(32, 4, sep=True), *_vgg_block(48, 4, sep=True),
                  *_vgg_block(64, 3, sep=True), L("flatten"), L("fc", 10)],
    "CifarNet5": [*_vgg_block(32, 6, sep=True), *_vgg_block(64, 6, sep=True),
                  *_vgg_block(96, 5, sep=True), L("flatten"), L("fc", 10)],
    "CifarNet6": [*_vgg_block(64, 2), *_vgg_block(128, 2),
                  *_vgg_block(256, 3), *_vgg_block(512, 3),
                  *_vgg_block(512, 3),
                  L("flatten"), L("fc", 512), *_act("sign"),
                  L("fc", 512), *_act("sign"), L("fc", 10)],
    "CifarNet2-typical": [*_vgg_block(16, 3), *_vgg_block(32, 3),
                          *_vgg_block(48, 3), L("flatten"), L("fc", 10)],
    "CifarNet7": [*[l if l.kind != "act" else L("act", act="relu")
                    for l in _vgg_block(64, 2) + _vgg_block(128, 2)
                    + _vgg_block(256, 3) + _vgg_block(512, 3)],
                  L("flatten"), L("fc", 512), L("bn"), L("act", act="relu"),
                  L("fc", 10)],
}

ALL_NETS = {**MNIST_NETS, **CIFAR_NETS}

INPUT_SHAPES = {**{k: (28, 28, 1) for k in MNIST_NETS},
                **{k: (32, 32, 3) for k in CIFAR_NETS}}


class _SignSTE(torch.autograd.Function):
    """Sign with the clipped straight-through gradient: forward ``x >= 0 ->
    +1`` else -1, backward ``g * (|x| <= 1)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    return _SignSTE.apply(x)


def init_bnn(seed: int, net: str, in_shape=None, device="cpu") -> Params:
    """He-normal weights from ``torch.Generator(seed)``, zero biases,
    identity BN statistics; float32 tensors on ``device``."""
    g = torch.Generator().manual_seed(int(seed))
    spec = ALL_NETS[net]
    h, w, c = in_shape or INPUT_SHAPES[net]
    params: Params = {}

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).to(device)

    def const(n, v):
        return torch.full((n,), float(v), device=device)

    for i, l in enumerate(spec):
        if l.kind == "conv":
            params[f"l{i}_w"] = normal((l.k, l.k, c, l.out),
                                       math.sqrt(2.0 / (l.k * l.k * c)))
            params[f"l{i}_b"] = const(l.out, 0)
            h, w, c = (h + 2 * l.pad - l.k) // l.stride + 1, \
                      (w + 2 * l.pad - l.k) // l.stride + 1, l.out
        elif l.kind == "sepconv":
            params[f"l{i}_dw"] = normal((l.k, l.k, 1, c),
                                        math.sqrt(2.0 / (l.k * l.k)))
            params[f"l{i}_pw"] = normal((1, 1, c, l.out), math.sqrt(2.0 / c))
            params[f"l{i}_b"] = const(l.out, 0)
            h, w, c = (h + 2 * l.pad - l.k) // l.stride + 1, \
                      (w + 2 * l.pad - l.k) // l.stride + 1, l.out
        elif l.kind == "fc":
            params[f"l{i}_w"] = normal((c, l.out), math.sqrt(2.0 / c))
            params[f"l{i}_b"] = const(l.out, 0)
            c = l.out
        elif l.kind == "bn":
            params[f"l{i}_g"] = const(c, 1)
            params[f"l{i}_beta"] = const(c, 0)
            params[f"l{i}_mu"] = const(c, 0)
            params[f"l{i}_var"] = const(c, 1)
        elif l.kind == "maxpool":
            h, w = h // 2, w // 2
        elif l.kind == "flatten":
            c = h * w * c
            h = w = 1
    return params


def _conv(x, w, stride, pad, groups=1):
    """NHWC x, HWIO w -> NHWC, through torch's NCHW/OIHW convolution."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def bnn_forward(params: Params, x: torch.Tensor, net: str,
                train: bool = False, binarize: bool = True):
    """x: (B, H, W, C) float.  Returns ``(logits, new_running_stats)``.

    Eval mode (the default) runs without autograd on the running BN
    statistics.  ``train=True`` normalises each BN by its batch mean and
    population variance (as ``jnp.var``), returns them detached under
    ``l{i}_mu`` / ``l{i}_var``, and binarizes through :func:`sign_ste`."""
    with contextlib.nullcontext() if train else torch.no_grad():
        return _forward(params, x, net, train, binarize)


def _forward(params: Params, x: torch.Tensor, net: str, train: bool,
             binarize: bool):
    stats = {}
    for i, l in enumerate(ALL_NETS[net]):
        if l.kind == "conv":
            x = _conv(x, params[f"l{i}_w"], l.stride, l.pad) + params[f"l{i}_b"]
        elif l.kind == "sepconv":
            x = _conv(x, params[f"l{i}_dw"], l.stride, l.pad,
                      groups=x.shape[-1])
            x = _conv(x, params[f"l{i}_pw"], 1, 0) + params[f"l{i}_b"]
        elif l.kind == "fc":
            x = x @ params[f"l{i}_w"] + params[f"l{i}_b"]
        elif l.kind == "bn":
            if train:
                dims = tuple(range(x.ndim - 1))
                mu = x.mean(dims)
                var = x.var(dims, correction=0)
                stats[f"l{i}_mu"] = mu.detach()
                stats[f"l{i}_var"] = var.detach()
            else:
                mu, var = params[f"l{i}_mu"], params[f"l{i}_var"]
            x = (x - mu) * torch.rsqrt(var + 1e-5) * params[f"l{i}_g"] \
                + params[f"l{i}_beta"]
        elif l.kind == "act":
            if l.act == "sign" and binarize:
                x = sign_ste(x)
            elif l.act == "sign":
                x = torch.tanh(x)
            else:
                x = torch.relu(x)
        elif l.kind == "maxpool":
            x = _maxpool(x)
        elif l.kind == "flatten":
            x = x.reshape(x.shape[0], -1)
    return x, stats


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride 2 over NHWC.  Its gradient goes to each window's first
    maximum in row-major order, as the reference's select-and-scatter does:
    after a Sign nearly every window ties."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def param_count(params: Params) -> int:
    return sum(p.numel() for p in params.values())
