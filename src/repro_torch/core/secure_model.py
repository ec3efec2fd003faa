"""Secure inference executor: a trained BNN under the CBNN protocol stack.

Port of ``repro/core/secure_model.py`` (``SecureModel``,
``compile_secure`` with ``deployment`` / ``autotune_cache``,
``_annotate_binary_paths``, ``_public_weight``, ``_weight_limbs_for``,
``_infer_linear_shared``, ``_infer_linear_public``, ``secure_infer``,
``secure_infer_cost``, ``post_sign_linear_cost``):

  setup (model owner): walk the layer spec, fold BN→Sign into a threshold
    (eq. 8) or BN into the linear's (W, b) (eqs. 10–11), then either share
    every weight with the reference's ``fold_in(key, kidx)`` sequence
    (``weights="shared"``) or keep it public in ring encoding
    (``weights="public"``), and cache the per-layer kernel operands.
  infer (all parties): every linear layer runs the path the compiler
    assigned (DESIGN.md §11): "arith" (fused matmul + Π_trunc, one opening
    round), "bin-shared" (post-Sign ±1 input, one reshare round),
    "bin-public" (local products, zero rounds) or "bin-public+trunc"
    (local products, the truncation opening only).  ``binary_linear``
    picks the post-Sign routing: "auto" the binary engine, "generic" the
    plain Alg-2 round (shared weights only; the engine's bit-identity
    reference), "off" the binarization-unaware ablation (±1 lifted to
    scale f, full truncation paid).  The cost model (cost_model.py)
    re-derives every label at compile time and may pin the engine per op
    (``op["engine"]``) and the kernels' launch choices (``op["kcfg"]``).
    Sign and ReLU run through the MSB extraction, maxpool after a Sign
    through the §3.6 fusion and after a ReLU through the pairwise-max
    tournament, a bare BN as the affine op, and the logits are opened.

``linear.set_fused_rounds(False)`` switches every layer to the paper's
round structure (linear + its own truncation round, Sign and ReLU by OT),
as in the reference.  The offline tape pool (preprocessing.py) runs the
same ``secure_infer`` on a tape-backed ``Parties``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from ..kernels.bin_rss_matmul import (GroupedWeightLimbs,
                                      grouped_weight_limbs,
                                      pair_grouped_limbs,
                                      public_grouped_limbs,
                                      public_weight_limbs)
from ..kernels.rss_matmul import (WeightLimbs, pair_weight_limbs,
                                  precompute_weight_limbs)
from ..nn.bnn import ALL_NETS
from . import comm, prf, transport
from .activation import (relu_from_msb, relu_from_msb_arith, sign_from_msb,
                         sign_from_msb_arith)
from .linear import (PublicTensor, bin_conv2d, bin_matmul, conv2d,
                     conv2d_truncate, fused_rounds, matmul, matmul_truncate,
                     mul, mul_truncate, reveal, truncate)
from .msb import msb_extract, msb_extract_arith
from .norm import fuse_bn_linear, fuse_bn_sign_threshold
from .pooling import secure_maxpool, sign_maxpool_fused
from .randomness import Parties, party_keys
from .ring import RingSpec, default_ring
from .rss import RSS, share

__all__ = ["SecureModel", "compile_secure", "secure_infer",
           "secure_infer_cost", "post_sign_linear_cost", "WEIGHT_MODES",
           "BINARY_LINEAR_MODES", "make_secure_infer_mesh",
           "secure_infer_mesh", "MeshSecureInfer"]

WEIGHT_MODES = ("shared", "public")
BINARY_LINEAR_MODES = ("auto", "generic", "off")


@dataclasses.dataclass
class SecureModel:
    ops: list
    ring: RingSpec
    net: str
    weights: str = "shared"        # "shared" | "public"  (DESIGN.md §11)
    binary_linear: str = "auto"    # "auto" | "generic" | "off"
    deployment: str | None = None  # descriptor the path solver ran against
    predicted: Any = None          # cost_model.CostReport from compile time


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _fold_bn(params, i):
    return (_np(params[f"l{i}_g"]), _np(params[f"l{i}_beta"]),
            _np(params[f"l{i}_mu"]), _np(params[f"l{i}_var"]))


def compile_secure(params: dict, net: str, key: prf.Key,
                   ring: RingSpec | None = None, device=None,
                   weights: str = "shared", binary_linear: str = "auto",
                   deployment=None, autotune_cache=None) -> SecureModel:
    """Model-owner setup: fuse + share (or publish).  ``params`` are
    float32 tensors in the bnn.py layout; the model lands on ``device``
    (default: the params').  Every linear weight gets its kernel operands
    cached (``WeightLimbs`` / ``GroupedWeightLimbs`` for shares,
    ``PublicWeightLimbs`` / ``PublicGroupedLimbs`` for public weights), so
    each layer runs as one kernel launch (the reference's
    ``use_kernel_dot=True``).

    ``weights="public"`` keeps the parameters in the clear (private input,
    public model): linear layers become local share algebra.
    ``binary_linear`` selects the post-Sign routing ("auto", "generic",
    "off"); "generic" is a shared-weights reference mode and is refused
    with public weights, as in the reference.

    ``deployment`` (a ``cost_model.DeploymentDescriptor`` or one of
    "local" / "lan" / "wan") makes the cost model's solver pick each
    linear layer's path by predicted time under it; with ``None`` it
    minimises (bytes, rounds, flops), which gives the fixed preference
    order's labels.  The prediction rides on ``op["cost"]`` and
    ``model.predicted``.  The solver also reads the autotuner's cache
    (``autotune_cache`` or the default path) and pins each launch's
    measured-best ``KernelConfig`` as ``op["kcfg"]``: every launch choice
    gives the same words, so this changes time, never values."""
    if weights not in WEIGHT_MODES:
        raise ValueError(f"weights must be one of {WEIGHT_MODES}, "
                         f"got {weights!r}")
    if binary_linear not in BINARY_LINEAR_MODES:
        raise ValueError(f"binary_linear must be one of "
                         f"{BINARY_LINEAR_MODES}, got {binary_linear!r}")
    if weights == "public" and binary_linear == "generic":
        raise ValueError('binary_linear="generic" is a shared-weights '
                         'reference mode; use "auto" or "off" with '
                         'weights="public"')
    ring = ring or default_ring()
    if device is None:
        device = next(v.device for v in params.values()
                      if isinstance(v, torch.Tensor))
    public = weights == "public"
    spec = ALL_NETS[net]
    ops: list[dict[str, Any]] = []
    i = 0
    kidx = 0

    def nk():
        nonlocal kidx
        kidx += 1
        return prf.fold_in(key, kidx)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def shared(a):
        return share(tensor(a), nk(), ring)

    def encoded(a):
        return ring.encode(tensor(a))

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
            if public:
                op["pub_w"] = [_public_weight(encoded(w), l.kind, j)
                               for j, w in enumerate(w_parts)]
                op["pub_b"] = encoded(b)
                op["pub_thresh"] = (encoded(sign_threshold)
                                    if sign_threshold is not None else None)
            else:
                op["w"] = [shared(w) for w in w_parts]
                op["b"] = shared(b)
                op["sign_threshold"] = (shared(sign_threshold)
                                        if sign_threshold is not None
                                        else None)
                op["wlimbs"] = [_weight_limbs_for(wr, l.kind, j)
                                for j, wr in enumerate(op["w"])]
            ops.append(op)
        elif l.kind == "act":
            ops.append({"op": "sign" if l.act == "sign" else "relu"})
        elif l.kind == "bn":
            # un-fused BN (no preceding linear): affine op
            g, beta, mu, var = _fold_bn(params, i)
            scale = g / np.sqrt(var + 1e-5)
            shift = beta - mu * scale
            if public:
                ops.append({"op": "affine", "pub_scale": encoded(scale),
                            "pub_shift": encoded(shift)})
            else:
                ops.append({"op": "affine", "scale": shared(scale),
                            "shift": shared(shift)})
        elif l.kind == "maxpool":
            ops.append({"op": "maxpool"})
        elif l.kind == "flatten":
            ops.append({"op": "flatten"})
        i += 1
    _annotate_binary_paths(ops, weights, binary_linear)
    from . import cost_model
    dep = cost_model.resolve_deployment(deployment)
    model = SecureModel(ops=ops, ring=ring, net=net, weights=weights,
                        binary_linear=binary_linear,
                        deployment=dep.name if dep else None)
    # the solver re-derives every path label (ties keep the preference
    # order) and stamps the prediction and the cached kernel configs
    model.predicted = cost_model.annotate_model(
        model, deployment=dep, autotune_cache=autotune_cache,
        device=device)
    return model


def _annotate_binary_paths(ops: list, weights: str = "shared",
                           binary_linear: str = "auto") -> None:
    """Stamp every linear op with ``binary_in`` (its input is a Sign
    layer's ±1 integers at scale 0; maxpool and flatten keep the domain)
    and its §11 ``path`` label: "arith", "bin-shared", "bin-public" or
    "bin-public+trunc"; sepconv gets a (depthwise, pointwise) pair.  The
    executor dispatches on these, so routing is decided at compile time.
    ``binary_in`` stays domain truth under "off", which lifts ±1 to scale
    f at run time and so labels post-Sign layers as arith routes."""
    public = weights == "public"
    binary = False

    def label(binary_in: bool) -> str:
        routed = binary_in and binary_linear != "off"
        if public:
            return "bin-public" if routed else "bin-public+trunc"
        if routed and binary_linear == "auto":
            return "bin-shared"
        return "arith"

    for op in ops:
        kind = op["op"]
        if kind in ("conv", "sepconv", "fc"):
            op["binary_in"] = binary
            if kind == "sepconv":
                # the pointwise input is the depthwise product at scale f
                op["path"] = (label(binary), label(False))
            else:
                op["path"] = label(binary)
            binary = False
        elif kind == "sign":
            binary = True
        elif kind in ("relu", "affine"):
            binary = False


def _public_weight(enc: torch.Tensor, kind: str,
                   part_idx: int) -> PublicTensor:
    """One public weight encoding with its kernel cache: dense layers get
    ``PublicWeightLimbs`` over the (K, N) matrix, the depthwise half of a
    sepconv the per-channel ``PublicGroupedLimbs`` (multiplier 1)."""
    if kind == "fc":
        return PublicTensor(enc, public_weight_limbs(enc))
    kh, kw, cin_g, cout = (int(d) for d in enc.shape)
    if kind == "conv" or (kind == "sepconv" and part_idx == 1):
        return PublicTensor(
            enc, public_weight_limbs(enc.reshape(kh * kw * cin_g, cout)))
    assert cin_g == 1, "depthwise kernels are (kh, kw, 1, Cin)"
    return PublicTensor(enc, public_grouped_limbs(
        enc.reshape(kh * kw, cout, 1).permute(1, 0, 2)))


def _weight_limbs_for(w: RSS, kind: str, part_idx: int):
    """Setup-time kernel operands of one weight-share stack: dense layers
    get ``WeightLimbs``; the depthwise half of a sepconv gets the
    per-channel ``GroupedWeightLimbs`` (multiplier 1, so Cout == Cin).
    A stack of three gives every slot's; a party's pair (2, ...) gives its
    own slot's alone, as a mesh rank builds it."""
    s = int(w.shares.shape[0])
    dense, grouped = ((precompute_weight_limbs, grouped_weight_limbs)
                      if s == 3 else (pair_weight_limbs, pair_grouped_limbs))
    if kind == "fc":
        return dense(w.shares)
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    if kind == "conv" or (kind == "sepconv" and part_idx == 1):
        return dense(w.shares.reshape(s, kh * kw * cin_g, cout))
    assert cin_g == 1, "depthwise kernels are (kh, kw, 1, Cin)"
    return grouped(w.shares.reshape(s, kh * kw, cout, 1).permute(0, 2, 1, 3))


def _infer_linear_shared(h: RSS, op: dict, parties: Parties, idx: int,
                         ring: RingSpec, binary_in: bool,
                         binary_engine: bool) -> RSS:
    """One shared-weight linear layer, dispatched by input domain.

    ``binary_in`` with ``binary_engine``: bin-shared (product at scale f,
    bias in the parts, one reshare).  Otherwise arith: the fused matmul +
    Π_trunc opening at scale 2f, or, for a post-Sign input under the
    "generic" routing, the plain Alg-2 round with a share-wise bias and no
    truncation, bit-identical to bin-shared (its reference)."""
    tp = transport.current()
    wlimbs = op["wlimbs"]
    kcfgs = op.get("kcfg") or [None] * len(op["w"])
    kind = op["op"]
    if kind == "sepconv":
        cin = int(h.shape[-1])
        if binary_in and binary_engine:
            h = bin_conv2d(h, op["w"][0], parties, stride=op["stride"],
                           padding=op["pad"], groups=cin,
                           tag=f"l{idx}.dwconv.bin", w_limbs=wlimbs[0])
        else:
            h = conv2d(h, op["w"][0], parties, stride=op["stride"],
                       padding=op["pad"], groups=cin, tag=f"l{idx}.dwconv",
                       w_limbs=wlimbs[0])
            if not binary_in:   # a post-Sign product already sits at f
                h = truncate(h, parties, tag=f"l{idx}.dwtrunc")
        at_2f = True
        lin, w_rss, wl, kc = "pw", op["w"][1], wlimbs[1], kcfgs[1]
    else:
        at_2f = not binary_in
        lin, w_rss, wl, kc = kind, op["w"][0], wlimbs[0], kcfgs[0]
    if not at_2f and binary_engine:
        bias = tp.own_view(op["b"].shares).reshape(
            (tp.parts_slots,) + (1,) * (h.ndim - 1) + (-1,))
        if lin == "fc":
            return bin_matmul(h, w_rss, parties, tag=f"l{idx}.fc.bin",
                              w_limbs=wl, bias_parts=bias, kcfg=kc)
        return bin_conv2d(h, w_rss, parties, stride=op["stride"],
                          padding=op["pad"], tag=f"l{idx}.conv.bin",
                          w_limbs=wl, bias_parts=bias, kcfg=kc)
    if at_2f and fused_rounds():
        # product + bias + Π_trunc in the one opening round; the bias rides
        # the additive parts, so only the own share
        bias = tp.own_view(op["b"].shares).reshape(
            (tp.parts_slots,) + (1,) * (h.ndim - 1) + (-1,)) * ring.scale
        if lin == "fc":
            return matmul_truncate(h, w_rss, parties, tag=f"l{idx}.fc",
                                   w_limbs=wl, bias_parts=bias, kcfg=kc)
        if lin == "conv":
            return conv2d_truncate(h, w_rss, parties, stride=op["stride"],
                                   padding=op["pad"], tag=f"l{idx}.conv",
                                   w_limbs=wl, bias_parts=bias, kcfg=kc)
        return conv2d_truncate(h, w_rss, parties, tag=f"l{idx}.pwconv",
                               w_limbs=wl, bias_parts=bias, kcfg=kc)
    # Alg 2's reshare, then the bias share-wise on the full RSS: the generic
    # route of a post-Sign layer (scale f, no truncation), or a fixed-point
    # layer paper-faithful (scale 2f, then its own truncation round)
    if lin == "fc":
        z = matmul(h, w_rss, parties, tag=f"l{idx}.fc", w_limbs=wl,
                   kcfg=kc)
    elif lin == "conv":
        z = conv2d(h, w_rss, parties, stride=op["stride"], padding=op["pad"],
                   tag=f"l{idx}.conv", w_limbs=wl, kcfg=kc)
    else:
        z = conv2d(h, w_rss, parties, tag=f"l{idx}.pwconv", w_limbs=wl,
                   kcfg=kc)
    bias = op["b"].shares.reshape(
        (z.shares.shape[0],) + (1,) * (z.ndim - 1) + (-1,))
    if at_2f:
        bias = bias * ring.scale
    z = RSS(z.shares + bias, ring)
    if at_2f:
        z = truncate(z, parties, tag=f"l{idx}.trunc")
    return z


def _infer_linear_public(h: RSS, op: dict, parties: Parties, idx: int,
                         ring: RingSpec, binary_in: bool) -> RSS:
    """One public-weight linear layer (bin-public path): every product is
    local share algebra, so the only protocol cost left is the truncation
    opening where the input carries scale f (first layer, the depthwise →
    pointwise seam, and every layer under "off"); post-Sign layers cost
    zero rounds and zero bytes."""
    kind = op["op"]
    pub_b = op["pub_b"]
    kcfgs = op.get("kcfg") or [None] * len(op["pub_w"])
    if kind == "sepconv":
        cin = int(h.shape[-1])
        h = bin_conv2d(h, op["pub_w"][0], parties, stride=op["stride"],
                       padding=op["pad"], groups=cin,
                       tag=f"l{idx}.dwconv.pub")
        if not binary_in:
            h = truncate(h, parties, tag=f"l{idx}.dwtrunc")
        # the pointwise input carries scale f, so the product lands at 2f
        h = bin_conv2d(h, op["pub_w"][1], parties, tag=f"l{idx}.pwconv.pub",
                       bias_public=pub_b * ring.scale, kcfg=kcfgs[1])
        return truncate(h, parties, tag=f"l{idx}.trunc")
    w = op["pub_w"][0]
    bias = pub_b if binary_in else pub_b * ring.scale
    if kind == "fc":
        h = bin_matmul(h, w, parties, tag=f"l{idx}.fc.pub", bias_public=bias,
                       kcfg=kcfgs[0])
    else:
        h = bin_conv2d(h, w, parties, stride=op["stride"], padding=op["pad"],
                       tag=f"l{idx}.conv.pub", bias_public=bias,
                       kcfg=kcfgs[0])
    if not binary_in:
        h = truncate(h, parties, tag=f"l{idx}.trunc")
    return h


def _infer_affine(h: RSS, op: dict, parties: Parties, idx: int,
                  ring: RingSpec, weights: str) -> RSS:
    """A bare BN (no preceding linear to fold into): h·scale + shift.

    Public weights: a local multiply by the encoded scale, the truncation
    opening, the public shift.  Shared weights: ``mul_truncate`` (fused)
    or ``mul`` + ``truncate`` (paper-faithful) on the shared scale, then
    the shared shift added with the party axis kept, shaped
    ``(3,) + (1,)*(ndim-1) + (C,)`` as every other bias.  (The reference
    adds the (3, C) shift stack to the (3, B, ..., C) activation as it is,
    which fails to broadcast or, at batch 1 with a 2-D activation, mixes
    the party and batch axes.)"""
    if weights == "public":
        h = RSS(h.shares * op["pub_scale"], ring)
        h = truncate(h, parties, tag=f"aff{idx}.tr")
        return h.add_public(op["pub_shift"])
    if fused_rounds():
        h = mul_truncate(h, op["scale"], parties, tag=f"aff{idx}")
    else:
        h = truncate(mul(h, op["scale"], parties, tag=f"aff{idx}"), parties,
                     tag=f"aff{idx}.tr")
    shift = op["shift"].shares.reshape(
        (h.shares.shape[0],) + (1,) * (h.ndim - 1) + (-1,))
    return RSS(h.shares + shift, ring)


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
            binary_in = op.get("binary_in", False)
            if model.binary_linear == "off" and binary_in:
                # binarization-unaware ablation: lift ±1 to scale f and
                # pay the full arithmetic opening
                h = h.mul_public_int(ring.scale)
                binary_in = False
            if model.weights == "public":
                h = _infer_linear_public(h, op, parties, idx, ring,
                                         binary_in)
                pending_sign_threshold = op.get("pub_thresh")
            else:
                # the compile-time solver may pin the engine per op; absent
                # that, the model-wide routing decides
                h = _infer_linear_shared(
                    h, op, parties, idx, ring, binary_in,
                    binary_engine=op.get("engine",
                                         model.binary_linear == "auto"))
                pending_sign_threshold = op.get("sign_threshold")
            prev_sign = False
        elif kind == "sign":
            t = pending_sign_threshold
            if isinstance(t, RSS):
                h = RSS(h.shares + t.shares.reshape(
                    (h.shares.shape[0],) + (1,) * (h.ndim - 1) + (-1,)), ring)
            elif t is not None:   # public threshold (ring encoding)
                h = h.add_public(t)
            pending_sign_threshold = None
            if fused_rounds():
                # 1 online round: multiply-open + local Alg 4
                _, msb_a = msb_extract_arith(h, parties, tag=f"sign{idx}.msb")
                bits = sign_from_msb_arith(msb_a)
            else:
                msb = msb_extract(h, parties, tag=f"sign{idx}.msb")
                bits = sign_from_msb(msb, parties, ring, tag=f"sign{idx}")
            nxt = model.ops[idx + 1]["op"] if idx + 1 < len(model.ops) else None
            if nxt == "maxpool":
                h = bits  # the §3.6 fusion consumes the indicator bits
            else:
                h = bits.mul_public_int(2).add_public(-1)
            prev_sign = True
        elif kind == "relu":
            if fused_rounds():
                _, msb_a = msb_extract_arith(h, parties, tag=f"relu{idx}.msb")
                h = relu_from_msb_arith(h, msb_a, parties, tag=f"relu{idx}")
            else:
                msb = msb_extract(h, parties, tag=f"relu{idx}.msb")
                h = relu_from_msb(h, msb, parties, tag=f"relu{idx}")
            prev_sign = False
        elif kind == "affine":
            h = _infer_affine(h, op, parties, idx, ring, model.weights)
            prev_sign = False
        elif kind == "maxpool":
            if prev_sign:
                bits = sign_maxpool_fused(h, parties, tag=f"mp{idx}")
                h = bits.mul_public_int(2).add_public(-1)
            else:
                h = secure_maxpool(h, parties, tag=f"mp{idx}")
        elif kind == "flatten":
            h = h.reshape(h.shape[0], math.prod(h.shape[1:]))
    if reveal_output:
        return reveal(h, tag="output", decode=True)
    return h


def secure_infer_cost(model: SecureModel, input_shape) -> comm.CommLedger:
    """Communication ledger of one query batch (``comm.estimate_cost``: a
    run on ``meta`` tensors, exact, nothing computed)."""
    parties = Parties.setup(prf.PRNGKey(7), device="meta")
    x = torch.empty((3,) + tuple(input_shape), dtype=model.ring.dtype)
    return comm.estimate_cost(
        lambda m, xs: secure_infer(m, RSS(xs, m.ring), parties), model, x)


def post_sign_linear_cost(model: SecureModel,
                          led: comm.CommLedger) -> tuple[int, int]:
    """(online bytes, online rounds) summed over the linear layers the
    compiler marked ``binary_in``: the post-Sign layers the binary-domain
    engine targets (DESIGN.md §11)."""
    idxs = {i for i, op in enumerate(model.ops)
            if op["op"] in ("conv", "sepconv", "fc")
            and op.get("binary_in", False)}
    nbytes = rounds = 0
    for tag, (r, b) in led.by_tag.items():
        if tag.startswith("pre:"):
            continue
        head = tag.split(".", 1)[0]
        if head.startswith("l") and head[1:].isdigit() \
                and int(head[1:]) in idxs:
            nbytes += b
            rounds += r
    return nbytes, rounds


# ---------------------------------------------------------------------------
# Mesh backend: one party's program in each of three processes
# ---------------------------------------------------------------------------

def _is_public_key(k) -> bool:
    """A model-ops entry is public iff it sits under a ``pub_*`` key (the
    bin-public path's weights, bias, threshold and affine): such tensors
    go whole to every party, not as a pair."""
    return isinstance(k, str) and k.startswith("pub")


# the kernel caches of share weights: each holds wf = w_s + w_{s+1} per slot
_SHARE_CACHES = (WeightLimbs, GroupedWeightLimbs)
# what the dealer's hand-off leaves where a share weight had a kernel cache:
# the rank builds its own slot's there, from its pair
OWN_SLOT = "own slot"


def _map_tensors(obj, fn, public: bool = False, caches=None):
    """``obj`` with every tensor leaf ``a`` replaced by ``fn(a, public)``,
    through dicts (``public`` set under a ``pub_*`` key), lists, tuples,
    NamedTuples (the kernels' caches) and dataclasses (``RSS``,
    ``PublicTensor``).  With ``caches``, a share weight's kernel cache is
    replaced by ``caches(cache)`` whole."""
    if caches is not None and isinstance(obj, _SHARE_CACHES):
        return caches(obj)
    if isinstance(obj, torch.Tensor):
        return fn(obj, public)
    sub = lambda v, pub=public: _map_tensors(v, fn, pub, caches)
    if isinstance(obj, dict):
        return {k: sub(v, public or _is_public_key(k))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [sub(v) for v in obj]
    if isinstance(obj, tuple):
        items = [sub(v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: sub(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _split_arrays(tree):
    """(party-stacked tensor leaves, public ``pub_*`` tensor leaves, a
    ``rebuild(shared, public)`` that puts new leaves back in order)."""
    shared, public = [], []
    _map_tensors(tree, lambda a, pub: (public if pub else shared).append(a))

    def rebuild(new_shared, new_public):
        its, itp = iter(new_shared), iter(new_public)
        return _map_tensors(tree, lambda a, pub: next(itp if pub else its))

    return shared, public, rebuild


def _pair(a: torch.Tensor, pid: int) -> torch.Tensor:
    """Rows (pid, pid+1) of a party-stacked tensor: P_pid's pair."""
    return a[[pid, (pid + 1) % 3]]


def hand_off(tree, pid: int):
    """The dealer's hand-off of a party-stacked tree (a classifier's ops,
    an LM's parameters) to P_pid: every share tensor as its pair, every
    public (``pub_*``) one whole, all on the host, and no kernel cache of
    a share weight: :data:`OWN_SLOT` stands in its place.  A cache's fused
    operand in the next slot is w_{i+1} + w_{i+2}, which beside w_i is the
    whole weight; each rank builds its own slot's cache from its pair
    instead (:func:`_weight_limbs_for`, ``pair_weight_limbs``), and 8 B a
    weight element cross rather than 56."""
    def pair(a, pub):
        if pub:
            return a.cpu()
        assert int(a.shape[0]) == 3, f"expected a party-stacked tensor: " \
            f"{tuple(a.shape)}"
        return _pair(a, pid).cpu()

    return _map_tensors(tree, pair, caches=lambda c: OWN_SLOT)


def check_pairs(tree, rank: int) -> None:
    """A rank's check of what the dealer handed it: every share tensor a
    pair (leading size 2) and no kernel cache of a share weight."""
    bad = []

    def see(a, pub):
        if not pub and int(a.shape[0]) != 2:
            bad.append(tuple(a.shape))

    _map_tensors(tree, see, caches=lambda c: bad.append(type(c).__name__))
    if bad:
        raise AssertionError(f"P{rank} holds more than its pair: {bad}")


def _pair_model(model: SecureModel, pid: int) -> SecureModel:
    """The dealer's hand-off of a classifier to P_pid (:func:`hand_off`)."""
    return dataclasses.replace(model, ops=hand_off(model.ops, pid),
                               predicted=None)


def _own_slot_caches(model: SecureModel) -> SecureModel:
    """A rank's pair model with its own slot's weight cache wherever the
    dealer's had one, built from its pair as ``compile_secure`` builds the
    stacked ones."""
    ops = []
    for op in model.ops:
        if "wlimbs" in op:
            op = dict(op, wlimbs=[
                _weight_limbs_for(w, op["op"], j) if c == OWN_SLOT else c
                for j, (w, c) in enumerate(zip(op["w"], op["wlimbs"]))])
        ops.append(op)
    return dataclasses.replace(model, ops=ops)


def _pair_slabs(slabs: dict, layout: dict, pid: int) -> dict:
    """One query's tape slabs for P_pid: stack-pair slabs as pairs, parts
    slabs as the own row, replicated slabs whole (host copies)."""
    from .preprocessing import REPLICATED, STACK_PAIR
    out = {}
    for k, v in slabs.items():
        if layout[k] == STACK_PAIR:
            out[k] = _pair(v, pid)
        elif layout[k] == REPLICATED:
            out[k] = v
        else:
            out[k] = v[pid:pid + 1]
    return {k: v.cpu() for k, v in out.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _triple(state) -> tuple:
    """(party id, the triple's global ranks, its process group) of this
    rank: rank r is P_{r mod 3} of data shard r // 3.  A group of three
    ranks is one triple on the default group; a larger one makes a process
    group a triple the first time (every rank joins every ``new_group``,
    in the same order)."""
    if "triple" not in state:
        world, rank = state.get("world", 3), state["rank"]
        if world == 3:
            state["triple"] = (rank, None, None)
        else:
            import torch.distributed as dist
            triples = [list(range(3 * t, 3 * t + 3))
                       for t in range(world // 3)]
            groups = [dist.new_group(tr) for tr in triples]
            state["triple"] = (rank % 3, triples[rank // 3],
                               groups[rank // 3])
    return state["triple"]


def _rank_setup_infer(state, key, model, spec, reveal_output, verify,
                      transport_wrap):
    """Party side of :class:`MeshSecureInfer`: check that the pair model
    holds no third slot, take it onto this rank's device and build its own
    slot's weight caches there."""
    from . import integrity
    dev = state["device"]
    pid, ranks, grp = _triple(state)
    check_pairs(model.ops, pid)
    m = _own_slot_caches(comm._to_device(model, dev))
    t = transport.MeshTransport(pid, ranks=ranks, group=grp)
    state[key] = {"model": m, "spec": spec, "reveal": reveal_output,
                  "wire": t.wire,
                  "transport": transport_wrap(t) if transport_wrap else t,
                  "verifier": (None if verify == "off"
                               else integrity.Verifier(verify))}
    _sync(dev)


def _check_keys(keys, rank: int) -> None:
    """A rank's check that the dealer sent it its two keys only."""
    if keys[(rank + 2) % 3] is not None or None in (
            keys[rank], keys[(rank + 1) % 3]):
        raise AssertionError(f"P{rank} was sent other keys than k_{rank} "
                             f"and k_{(rank + 1) % 3}")


def _rank_drop(state, key):
    state.pop(key, None)


def _protocol_modes() -> tuple:
    """The process-global protocol toggles (fused rounds, matmul mode),
    which the dealer carries to the party processes with every task."""
    from . import linear
    return linear.fused_rounds(), linear._MATMUL_MODE


def _set_protocol_modes(modes: tuple) -> None:
    from . import linear
    linear.set_fused_rounds(modes[0])
    linear.set_matmul_mode(modes[1])


def _rank_infer(state, key, keys, inputs, modes, profile=False):
    """Party side of one batch of queries: ``inputs`` is a list of (x
    pair, tape slabs or None), staged onto the device before the clock;
    the ranks start together (a barrier) and each query is timed to the
    device's completion.  Returns the last query's output, and per query
    its seconds, wire counts, digest report (under a verifier) and, for
    the first, its ledger and the verifier's op list."""
    import torch.distributed as dist

    from ..kernels import build as kbuild
    from . import integrity
    from .preprocessing import TapeParties
    _check_keys(keys, _triple(state)[0])
    _set_protocol_modes(modes)
    st = state[key]
    dev = state["device"]
    m, spec, v, t, wire = (st["model"], st["spec"], st["verifier"],
                           st["transport"], st["wire"])
    staged = [comm._to_device(i, dev) for i in inputs]
    _sync(dev)

    prf_calls = [0]
    threefry = prf._threefry_tensor

    def counted(*a):   # this rank's PRF evaluations, counted per query
        prf_calls[0] += 1
        return threefry(*a)

    def query(x_pair, slabs):
        prt = (TapeParties(keys, slabs, spec) if spec is not None
               else Parties(keys, device=dev))
        prf._threefry_tensor = counted
        try:
            with transport.use_transport(t), comm.listening(wire.listen), \
                    comm.track() as led, integrity.verify_scope(v):
                out = secure_infer(m, RSS(x_pair, m.ring), prt,
                                   reveal_output=st["reveal"])
                rep = v.traced_report() if v is not None else None
        finally:
            prf._threefry_tensor = threefry
        return out, led, rep

    launches0 = dict(kbuild.LAUNCHES)
    records = []
    dist.barrier()
    t_all = time.perf_counter()
    out = None
    for q, (x_pair, slabs) in enumerate(staged):
        wire.reset()
        prf_calls[0] = 0
        tq = time.perf_counter()
        out, led, rep = query(x_pair, slabs)
        _sync(dev)
        rec = {"start": tq, "seconds": time.perf_counter() - tq,
               "wire": wire.summary(), "prf_calls": prf_calls[0]}
        if rep is not None:
            rec["report"] = {k: r.cpu() for k, r in rep.items()}
        if q == 0:
            rec["ledger"] = led.as_dict()
            if v is not None:
                rec["meta"] = list(v.meta)
        records.append(rec)
    seconds = time.perf_counter() - t_all
    launches = {k: c - launches0[k] for k, c in kbuild.LAUNCHES.items()
                if c != launches0[k]}
    prof = None
    if profile and dev.type == "cuda":
        from ..launch.profiling import profile_once
        x_pair, slabs = staged[-1]
        prof = profile_once(lambda: query(x_pair, slabs), dev,
                            seconds / len(staged))
    if st["reveal"]:
        res = out.cpu()
    else:
        res = t.own_view(out.shares).cpu()
    return {"out": res, "queries": records, "seconds": seconds,
            "launches": launches, "profile": prof}


class MeshSecureInfer:
    """The runner :func:`make_secure_infer_mesh` returns: the dealer side
    of secure inference with one party a process.

    ``runner(keys, x_stack)`` (or ``runner(keys, x_stack, slabs)`` with a
    tape spec) runs one query and returns the opened logits (each
    triple's three openings, checked equal, its data shard's rows in
    order) or, with ``reveal_output=False``, the output RSS stacked from
    the ranks' own shares.  :meth:`run` serves a batch of queries and
    returns every rank's measurements too."""

    _count = 0

    def __init__(self, model: SecureModel, group, reveal_output, tape_spec,
                 verifier, transport_wrap, data: int = 1):
        if group.ranks != 3 * data:
            raise ValueError(f"{data} data shard(s) run on {3 * data} "
                             f"ranks; the group has {group.ranks}")
        if data > 1 and tape_spec is not None:
            raise ValueError("tape playback is traced at the whole batch: "
                             "it runs party-only (data=1)")
        if data > 1 and verifier is not None:
            raise ValueError("verified mesh serving runs party-only "
                             "(data=1): the digest report is a party's")
        MeshSecureInfer._count += 1
        self.key = f"infer{MeshSecureInfer._count}"
        self.model, self.group, self.data = model, group, data
        self.reveal_output = reveal_output
        self.tape_spec, self.verifier = tape_spec, verifier
        self.layout = ({k: v.layout for k, v in tape_spec.slabs.items()}
                       if tape_spec is not None else None)
        self.last = None
        pairs = [_pair_model(model, p) for p in range(3)]
        group.run(_rank_setup_infer, [
            (self.key, pairs[r % 3], tape_spec, reveal_output,
             verifier.mode if verifier is not None else "off",
             transport_wrap) for r in range(group.ranks)])

    def prepare(self, x_stack: torch.Tensor, slabs: dict | None = None):
        """The dealer's staging of one query, outside the online program:
        each rank's input pair (its data shard's rows) and tape slabs, on
        the host."""
        if (slabs is None) != (self.tape_spec is None):
            raise ValueError("tape slabs go with a tape spec, and only then")
        b = x_stack.shape[1]
        if b % self.data:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{self.data} data shards")
        step = b // self.data
        shards = [x_stack[:, t * step:(t + 1) * step]
                  for t in range(self.data)]
        return [(_pair(shards[r // 3], r % 3).cpu(),
                 None if slabs is None
                 else _pair_slabs(slabs, self.layout, r % 3))
                for r in range(self.group.ranks)]

    def run(self, keys, prepared: list, profile: bool = False) -> dict:
        """Serve ``prepared`` (a list of :meth:`prepare` results, one a
        query) in one batch.  Checks every query's digest report under a
        verifier (raising ``IntegrityError`` before any output is
        released) and that each triple's ranks opened the same logits;
        returns ``{"out", "ranks": [each rank's measurements]}``."""
        n = self.group.ranks
        ranks = self.group.run(_rank_infer, [
            (self.key, party_keys(keys, r % 3), [p[r] for p in prepared],
             _protocol_modes(), profile) for r in range(n)])
        self.last = {"out": None, "ranks": ranks}
        if self.verifier is not None:
            v = self.verifier
            first = ranks[0]["queries"][0]
            # the op list and rank 0's digests, as a local run leaves them
            v.meta = first["meta"]
            v.rows = {k: list(r.unbind(-1))
                      for k, r in first["report"].items()}
            for q in range(len(prepared)):
                rows = [ranks[r]["queries"][q]["report"] for r in range(3)]
                v.check({k: torch.stack([rw[k] for rw in rows])
                         for k in rows[0]})
        outs = [rk["out"] for rk in ranks]
        if self.reveal_output:
            for r in range(n):
                if not torch.equal(outs[r], outs[r - r % 3]):
                    raise RuntimeError(f"P{r % 3} of data shard {r // 3} "
                                       f"opened other logits than P0")
            out = torch.cat(outs[::3])
        else:
            out = RSS(torch.cat([torch.cat(outs[3 * t:3 * t + 3])
                                 for t in range(self.data)], dim=1),
                      self.model.ring)
        self.last["out"] = out
        return self.last

    def __call__(self, keys, x_stack, slabs=None):
        return self.run(keys, [self.prepare(x_stack, slabs)])["out"]

    def close(self) -> None:
        if not self.group.closed:
            self.group.run(_rank_drop, (self.key,))


def make_secure_infer_mesh(model: SecureModel, group=None, *,
                           reveal_output: bool = True, tape_spec=None,
                           verifier=None, transport_wrap=None,
                           data: int = 1) -> MeshSecureInfer:
    """Secure inference with each party's program in its own process: a
    :class:`MeshSecureInfer` over ``group`` (a
    :class:`~.party_group.PartyGroup` of 3 x ``data`` ranks; default: a
    new one on the model's device).  Port of the reference's
    ``make_secure_infer_mesh``, its ``batch_axis`` as ``data``.

    The dealer (this process) splits the model's party-stacked tensors
    from its ``pub_*`` tensors and hands each rank only its pair (own +
    next) and the public tensors whole; each rank checks that it holds no
    third slot.  Every rank runs :func:`secure_infer` under a
    :class:`~.transport.MeshTransport` with its own ``Parties`` (or, with
    ``tape_spec``, a ``TapeParties`` on its slabs: stack-pair slabs as
    pairs, parts slabs as its row, replicated slabs whole; no PRF call).
    Same shapes give the local run's PRF words, so on three ranks the
    opened logits equal ``secure_infer``'s on the stacked simulation bit
    for bit.

    ``data`` > 1 (the party x data batch axis): rank r is P_{r mod 3} of
    data shard r // 3; the dealer splits the (3, B, ...) stack along the
    batch and each triple serves its shard, its reshares and openings
    within the triple (a process group each).  Every shard starts its
    parties from the same keys and counter, as the reference's shard body
    does, so the logits are ``secure_infer`` of each shard, concatenated:
    the PRF words of a shard's shape, not the whole batch's (the
    truncation's ulps may differ from a whole-batch run).  No tape and no
    verifier with ``data`` > 1 (the reference's refusals).

    ``verifier`` (an ``integrity.Verifier``): every rank digests its
    message views; the reports come back through the task channel (not
    the process group, so the wire holds only protocol traffic) and the
    dealer stacks them to (3, n) and runs ``verifier.check`` before it
    releases the logits.  ``transport_wrap(t)`` wraps each rank's
    transport (``integrity.FaultInjectingTransport``, as a picklable
    ``functools.partial``)."""
    if group is None:
        from .party_group import PartyGroup
        group = PartyGroup(_model_device(model), ranks=3 * data)
    return MeshSecureInfer(model, group, reveal_output, tape_spec, verifier,
                           transport_wrap, data)


def _model_device(model: SecureModel) -> torch.device:
    shared, public, _ = _split_arrays(model.ops)
    return (shared or public)[0].device


def secure_infer_mesh(model: SecureModel, x_shares: RSS, parties: Parties,
                      group=None, *, reveal_output: bool = True):
    """One secure inference with each party a process (the reference's
    ``secure_infer_mesh``): the opened logits, bit-identical to
    :func:`secure_infer` on the stacked simulation, or with
    ``reveal_output=False`` the output RSS.  Without a ``group`` one is
    started on the model's device and stopped after the query."""
    from .party_group import PartyGroup
    own = group is None
    group = group or PartyGroup(_model_device(model))
    try:
        fn = make_secure_infer_mesh(model, group, reveal_output=reveal_output)
        return fn(parties.keys, x_shares.shares)
    finally:
        if own:
            group.close()
