"""Secure inference executor: a trained BNN under the CBNN protocol stack.

Port of ``repro/core/secure_model.py`` (``SecureModel``,
``compile_secure``, ``_annotate_binary_paths``, ``_weight_limbs_for``,
``_infer_linear_shared``, ``secure_infer``, ``secure_infer_cost``) for the
shared-weight deployment with the binary-domain engine and fused rounds:

  setup (model owner): walk the layer spec, fold BN→Sign into a shared
    threshold (eq. 8) or BN into the linear's (W, b) (eqs. 10–11), share
    every weight with the reference's ``fold_in(key, kidx)`` sequence and
    cache the per-layer kernel operands.
  infer (all parties): every linear layer runs the path the compiler
    assigned ("arith": fused matmul + Π_trunc, one opening round;
    "bin-shared": post-Sign ±1 input, one reshare round), Sign through
    the fused MSB extraction, Sign→maxpool fused, and the logits opened.

Public weights, the generic/off binary engines, the paper-faithful rounds,
ReLU nets (``secure_maxpool``) and the offline tape pool belong to later
slices; the executor raises ``NotImplementedError`` on layers it cannot run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..kernels.bin_rss_matmul import GroupedWeightLimbs, grouped_weight_limbs
from ..kernels.rss_matmul import WeightLimbs, precompute_weight_limbs
from ..nn.bnn import ALL_NETS
from . import comm, prf, transport
from .activation import sign_from_msb_arith
from .linear import (bin_conv2d, bin_matmul, conv2d, conv2d_truncate,
                     matmul_truncate, reveal, truncate)
from .msb import msb_extract_arith
from .norm import fuse_bn_linear, fuse_bn_sign_threshold
from .pooling import sign_maxpool_fused
from .randomness import Parties
from .ring import RingSpec, default_ring
from .rss import RSS, share

__all__ = ["SecureModel", "compile_secure", "secure_infer",
           "secure_infer_cost"]

@dataclasses.dataclass
class SecureModel:
    ops: list
    ring: RingSpec
    net: str


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _fold_bn(params, i):
    return (_np(params[f"l{i}_g"]), _np(params[f"l{i}_beta"]),
            _np(params[f"l{i}_mu"]), _np(params[f"l{i}_var"]))


def compile_secure(params: dict, net: str, key: prf.Key,
                   ring: RingSpec | None = None,
                   device=None) -> SecureModel:
    """Model-owner setup: fuse + share.  ``params`` are float32 tensors in
    the bnn.py layout; shares land on ``device`` (default: the params').
    Every linear weight-share stack gets its kernel operands cached
    (``WeightLimbs`` / ``GroupedWeightLimbs``), so each layer runs as one
    kernel launch (the reference's ``use_kernel_dot=True``, with shared
    weights and the binary engine on ``"auto"``)."""
    ring = ring or default_ring()
    if device is None:
        device = next(v.device for v in params.values()
                      if isinstance(v, torch.Tensor))
    spec = ALL_NETS[net]
    ops: list[dict[str, Any]] = []
    i = 0
    kidx = 0

    def nk():
        nonlocal kidx
        kidx += 1
        return prf.fold_in(key, kidx)

    def shared(a):
        return share(torch.as_tensor(np.asarray(a, np.float32),
                                     device=device), nk(), ring)

    while i < len(spec):
        l = spec[i]
        if l.kind in ("conv", "sepconv", "fc"):
            if l.kind == "sepconv":
                w_parts = [_np(params[f"l{i}_dw"]), _np(params[f"l{i}_pw"])]
            else:
                w_parts = [_np(params[f"l{i}_w"])]
            b = _np(params[f"l{i}_b"])
            nxt = spec[i + 1] if i + 1 < len(spec) else None
            nxt2 = spec[i + 2] if i + 2 < len(spec) else None
            sign_threshold = None
            if nxt is not None and nxt.kind == "bn":
                g, beta, mu, var = _fold_bn(params, i + 1)
                gp = g / np.sqrt(var + 1e-5)
                if nxt2 is not None and nxt2.kind == "act" \
                        and nxt2.act == "sign" and np.all(gp > 0):
                    sign_threshold = fuse_bn_sign_threshold(g, beta, mu, var)
                else:
                    w_parts[-1], b = fuse_bn_linear(w_parts[-1], b, g, beta,
                                                    mu, var)
                i += 1  # consume bn
            op = {"op": l.kind, "k": l.k, "stride": l.stride, "pad": l.pad}
            op["w"] = [shared(w) for w in w_parts]
            op["b"] = shared(b)
            op["sign_threshold"] = (shared(sign_threshold)
                                    if sign_threshold is not None else None)
            op["wlimbs"] = [_weight_limbs_for(wr, l.kind, j)
                            for j, wr in enumerate(op["w"])]
            ops.append(op)
        elif l.kind == "act":
            ops.append({"op": "sign" if l.act == "sign" else "relu"})
        elif l.kind == "bn":
            # un-fused BN (no preceding linear): shared affine
            g, beta, mu, var = _fold_bn(params, i)
            scale = g / np.sqrt(var + 1e-5)
            shift = beta - mu * scale
            ops.append({"op": "affine", "scale": shared(scale),
                        "shift": shared(shift)})
        elif l.kind == "maxpool":
            ops.append({"op": "maxpool"})
        elif l.kind == "flatten":
            ops.append({"op": "flatten"})
        i += 1
    _annotate_binary_paths(ops)
    return SecureModel(ops=ops, ring=ring, net=net)


def _annotate_binary_paths(ops: list) -> None:
    """Stamp every linear op with ``binary_in`` (its input is a Sign
    layer's ±1 integers at scale 0) and its §11 ``path`` label (shared
    weights, binary engine on ``"auto"``); sepconv gets a (depthwise,
    pointwise) pair.  The executor dispatches on these, so routing is
    decided at compile time."""
    binary = False

    def label(binary_in: bool) -> str:
        return "bin-shared" if binary_in else "arith"

    for op in ops:
        kind = op["op"]
        if kind in ("conv", "sepconv", "fc"):
            op["binary_in"] = binary
            if kind == "sepconv":
                op["path"] = (label(binary), label(False))
            else:
                op["path"] = label(binary)
            binary = False
        elif kind == "sign":
            binary = True
        elif kind in ("relu", "affine"):
            binary = False


def _weight_limbs_for(w: RSS, kind: str, part_idx: int):
    """Setup-time kernel operands of one weight-share stack: dense layers
    get ``WeightLimbs``; the depthwise half of a sepconv gets the
    per-channel ``GroupedWeightLimbs`` (multiplier 1, so Cout == Cin)."""
    if kind == "fc":
        return precompute_weight_limbs(w.shares)
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    if kind == "conv" or (kind == "sepconv" and part_idx == 1):
        return precompute_weight_limbs(
            w.shares.reshape(3, kh * kw * cin_g, cout))
    assert cin_g == 1, "depthwise kernels are (kh, kw, 1, Cin)"
    return grouped_weight_limbs(
        w.shares.reshape(3, kh * kw, cout, 1).permute(0, 2, 1, 3))


def _infer_linear_shared(h: RSS, op: dict, parties: Parties, idx: int,
                         ring: RingSpec, binary_in: bool) -> RSS:
    """One shared-weight linear layer, dispatched by input domain:
    bin-shared (product at scale f, bias in the parts, one reshare) or
    arith (fused matmul + Π_trunc opening at scale 2f)."""
    tp = transport.current()
    wlimbs = op["wlimbs"]
    kind = op["op"]
    if kind == "sepconv":
        cin = int(h.shape[-1])
        if binary_in:
            h = bin_conv2d(h, op["w"][0], parties, stride=op["stride"],
                           padding=op["pad"], groups=cin,
                           tag=f"l{idx}.dwconv.bin", w_limbs=wlimbs[0])
        else:
            h = conv2d(h, op["w"][0], parties, stride=op["stride"],
                       padding=op["pad"], groups=cin, tag=f"l{idx}.dwconv",
                       w_limbs=wlimbs[0])
            h = truncate(h, parties, tag=f"l{idx}.dwtrunc")
        at_2f = True
        lin, w_rss, wl = "pw", op["w"][1], wlimbs[1]
    else:
        at_2f = not binary_in
        lin, w_rss, wl = kind, op["w"][0], wlimbs[0]
    bias = tp.own_view(op["b"].shares).reshape(
        (tp.parts_slots,) + (1,) * (h.ndim - 1) + (-1,))
    if not at_2f:
        if lin == "fc":
            return bin_matmul(h, w_rss, parties, tag=f"l{idx}.fc.bin",
                              w_limbs=wl, bias_parts=bias)
        return bin_conv2d(h, w_rss, parties, stride=op["stride"],
                          padding=op["pad"], tag=f"l{idx}.conv.bin",
                          w_limbs=wl, bias_parts=bias)
    bias = bias * ring.scale
    if lin == "fc":
        return matmul_truncate(h, w_rss, parties, tag=f"l{idx}.fc",
                               w_limbs=wl, bias_parts=bias)
    if lin == "conv":
        return conv2d_truncate(h, w_rss, parties, stride=op["stride"],
                               padding=op["pad"], tag=f"l{idx}.conv",
                               w_limbs=wl, bias_parts=bias)
    return conv2d_truncate(h, w_rss, parties, tag=f"l{idx}.pwconv",
                           w_limbs=wl, bias_parts=bias)


def secure_infer(model: SecureModel, x_shares: RSS, parties: Parties,
                 reveal_output: bool = True):
    """Run one secure inference.  x_shares: RSS of (B,H,W,C) or (B,D).
    Returns the opened float32 logits (or the output RSS)."""
    parties = parties.fresh()
    ring = model.ring
    h = x_shares
    prev_sign = False
    pending_sign_threshold = None
    for idx, op in enumerate(model.ops):
        kind = op["op"]
        if kind in ("conv", "sepconv", "fc"):
            h = _infer_linear_shared(h, op, parties, idx, ring,
                                     op.get("binary_in", False))
            prev_sign = False
            pending_sign_threshold = op.get("sign_threshold")
        elif kind == "sign":
            if pending_sign_threshold is not None:
                t = pending_sign_threshold.shares
                h = RSS(h.shares + t.reshape(
                    (h.shares.shape[0],) + (1,) * (h.ndim - 1) + (-1,)), ring)
                pending_sign_threshold = None
            # 1 online round: multiply-open + local Alg-4
            _, msb_a = msb_extract_arith(h, parties, tag=f"sign{idx}.msb")
            bits = sign_from_msb_arith(msb_a)
            nxt = model.ops[idx + 1]["op"] if idx + 1 < len(model.ops) else None
            if nxt == "maxpool":
                h = bits  # the §3.6 fusion consumes the indicator bits
            else:
                h = bits.mul_public_int(2).add_public(-1)
            prev_sign = True
        elif kind == "maxpool":
            if not prev_sign:
                raise NotImplementedError(
                    "secure_maxpool (maxpool after a non-Sign layer) belongs "
                    "to a later slice of the port")
            bits = sign_maxpool_fused(h, parties, tag=f"mp{idx}")
            h = bits.mul_public_int(2).add_public(-1)
        elif kind == "flatten":
            h = h.reshape(h.shape[0], math.prod(h.shape[1:]))
        else:
            raise NotImplementedError(
                f"{kind!r} layers (ReLU nets, bare BN) belong to a later "
                f"slice of the port")
    if reveal_output:
        return reveal(h, tag="output", decode=True)
    return h


def _to_device(obj, device):
    """A copy of a model-ops tree with every tensor moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, RSS):
        return RSS(obj.shares.to(device), obj.ring)
    if isinstance(obj, (WeightLimbs, GroupedWeightLimbs)):
        return type(obj)(*(a.to(device) for a in obj))
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    return obj


def secure_infer_cost(model: SecureModel, input_shape) -> comm.CommLedger:
    """Communication ledger of one query batch, from a run on ``meta``
    tensors: every protocol records its messages from shapes alone, so
    the ledger is exact and nothing is computed."""
    meta = dataclasses.replace(model, ops=_to_device(model.ops, "meta"))
    parties = Parties.setup(prf.PRNGKey(7), device="meta")
    x = torch.empty((3,) + tuple(input_shape), dtype=model.ring.dtype,
                    device="meta")
    with comm.track() as led:
        secure_infer(meta, RSS(x, model.ring), parties)
    return led
