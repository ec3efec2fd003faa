"""Linear-layer protocols over RSS (paper Algorithm 2) + truncation + reveal.

Port of ``repro/core/linear.py``: ``reveal``, ``_reshare``,
``_mul_parts``, ``mul``, ``square``, ``_matmul_parts``, ``matmul``,
``mul_open``, ``matmul_truncate``, ``mul_truncate``, ``square_truncate``,
the convolutions, ``PublicTensor``, ``bin_matmul`` / ``bin_conv2d``,
``truncate``, ``truncate_probabilistic``, ``linear_layer`` and the two
protocol toggles ``set_matmul_mode`` / ``set_fused_rounds`` (process
globals, as in the reference).  ``kcfg`` (a
``kernels.lowering.KernelConfig`` that ``compile_secure`` reads from the
autotuner's cache) rides down to the dense kernels' launches; it changes
their schedule, never their values.

Multiplication identity (Araki et al.): per party
    z_i = x_i·y_i + x_{i+1}·y_i + x_i·y_{i+1} + a_i,   Σ a_i = 0
("paper3", Algorithm 2 verbatim, 3 products per party), or in the default
fused-operand form ("opt2", 2 products per party)
    z_i = x_i·(y_i + y_{i+1}) + x_{i+1}·y_i + a_i.
With cached weights (``w_limbs``, what ``compile_secure`` always builds)
the whole 3-party product of a layer is one kernel launch (kernels/ops.py),
whatever the mode.  Otherwise each per-party product goes through ``dot``:
``kernels.ops.rss_matmul_dot`` runs it on the ring-matmul kernel; with no
``dot`` the plain torch product runs, on CPU tensors only (torch has no
integer matmul on CUDA), and raises on a CUDA tensor so that nothing on
the card bypasses the kernels.  Public weights (a :class:`PublicTensor`)
follow the same rule.

``set_fused_rounds(False)`` restores the paper-faithful round structure
(here: a linear layer's truncation as its own opening round after the
reshare, in ``linear_layer``; the MSB, Sign, ReLU and executor modules
read :func:`fused_rounds` too).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import comm, transport
from .randomness import Parties
from .ring import RingSpec, shr
from .rss import RSS, _add_slot0

__all__ = ["reveal", "mul", "matmul", "conv2d", "truncate",
           "truncate_probabilistic", "linear_layer",
           "square", "set_matmul_mode", "set_fused_rounds", "fused_rounds",
           "mul_open", "matmul_truncate", "conv2d_truncate", "mul_truncate",
           "square_truncate", "PublicTensor", "bin_matmul", "bin_conv2d"]

# "opt2" = fused-operand (2 products per party); "paper3" = Algorithm 2
# verbatim (3 per party).
_MATMUL_MODE = "opt2"
# Round-fused protocol variants (mul_open, matmul_truncate, the local Sign
# conversion): on by default; False restores the paper's round structure.
_FUSED_ROUNDS = True


def set_matmul_mode(mode: str) -> None:
    global _MATMUL_MODE
    if mode not in ("opt2", "paper3"):
        raise ValueError(f"matmul mode must be 'opt2' or 'paper3', "
                         f"got {mode!r}")
    _MATMUL_MODE = mode


def set_fused_rounds(on: bool) -> None:
    global _FUSED_ROUNDS
    _FUSED_ROUNDS = bool(on)


def fused_rounds() -> bool:
    return _FUSED_ROUNDS


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def reveal(x: RSS, tag: str = "reveal", decode: bool = False):
    """Open x to all parties: P_i sends x_i to P_{i-1}; 1 round, 3 elements."""
    comm.record(tag, rounds=1, nbytes=3 * _numel(x.shape) * x.ring.nbytes)
    total = transport.current().open_rss(x.shares)
    return x.ring.decode(total) if decode else total


def _reshare(z_parts, ring: RingSpec, parties: Parties, tag: str) -> RSS:
    """Add the 3-of-3 zero mask to the additive parts and reshare
    (P_i -> P_{i-1}): one round, one ring element per slot and party."""
    a = parties.zero_shares(z_parts.shape[1:], ring)
    z = z_parts + a
    comm.record(tag, rounds=1, nbytes=3 * _numel(z.shape[1:]) * ring.nbytes)
    return RSS(transport.current().complete(z), ring)


def _align_party_axis(xs, ys):
    """Broadcast two share stacks, keeping axis 0 as the party axis."""
    nd = max(xs.ndim, ys.ndim)
    if xs.ndim < nd:
        xs = xs.reshape(xs.shape[:1] + (1,) * (nd - xs.ndim) + xs.shape[1:])
    if ys.ndim < nd:
        ys = ys.reshape(ys.shape[:1] + (1,) * (nd - ys.ndim) + ys.shape[1:])
    return xs, ys


def _mul_parts(xs, ys):
    """Elementwise additive product stack z_i, in the matmul mode."""
    t = transport.current()
    xo, yo = t.own_view(xs), t.own_view(ys)
    xn, yn = t.next_view(xs), t.next_view(ys)
    if _MATMUL_MODE == "opt2":
        return xo * (yo + yn) + xn * yo
    return xo * yo + xn * yo + xo * yn


def mul(x: RSS, y: RSS, parties: Parties, tag: str = "mul") -> RSS:
    """Elementwise secure multiplication (output scale = sum of scales)."""
    xs, ys = _align_party_axis(x.shares, y.shares)
    return _reshare(_mul_parts(xs, ys), x.ring, parties, tag)


def _square_parts(x: RSS):
    t = transport.current()
    xo, xn = t.own_view(x.shares), t.next_view(x.shares)
    return xo * xo + 2 * xo * xn


def square(x: RSS, parties: Parties, tag: str = "square") -> RSS:
    """x^2 with one fewer local product: z_i = x_i^2 + 2·x_i·x_{i+1}."""
    return _reshare(_square_parts(x), x.ring, parties, tag)


def _plain_route(x: RSS, what: str) -> None:
    """The products without cached weight limbs and without a ``dot`` are
    for CPU tensors: on the card the kernels are the only route."""
    if x.shares.device.type == "cuda":
        raise RuntimeError(f"{what} without cached weight limbs or a kernel "
                           f"dot runs on CPU tensors only; compile_secure "
                           f"caches the limbs for the CUDA kernels")


def _matmul_parts(x: RSS, w: RSS | None, w_limbs=None,
                  dot=None, kcfg=None) -> torch.Tensor:
    """Additive product stack z_i (parts layout): local compute, no comm.

    With ``w_limbs`` (a kernels.rss_matmul.WeightLimbs cached at model
    setup) the whole 3-party product is one kernel launch, whatever the
    matmul mode or ``dot``.  Otherwise the mode's identity runs as
    per-party products through ``dot`` (``kernels.ops.rss_matmul_dot``:
    one ring-matmul launch each), or as plain integer matmuls (CPU only)."""
    t = transport.current()
    if w_limbs is not None:
        from ..kernels.ops import rss_matmul_parts_op
        return rss_matmul_parts_op(t.own_view(x.shares), w_limbs, cfg=kcfg)
    if dot is None:
        _plain_route(x, "matmul")
        dot = torch.matmul
    xo, wo = t.own_view(x.shares), t.own_view(w.shares)
    xn, wn = t.next_view(x.shares), t.next_view(w.shares)
    slots = xo.shape[0]
    if _MATMUL_MODE == "opt2":
        return torch.stack([dot(xo[i], wo[i] + wn[i]) + dot(xn[i], wo[i])
                            for i in range(slots)])
    return torch.stack([dot(xo[i], wo[i]) + dot(xn[i], wo[i])
                        + dot(xo[i], wn[i]) for i in range(slots)])


def matmul(x: RSS, w: RSS | None, parties: Parties, tag: str = "matmul",
           w_limbs=None, dot=None, kcfg=None) -> RSS:
    """Secure matmul z = x @ w (x: (..., K), w: (K, N)), one reshare."""
    return _reshare(_matmul_parts(x, w, w_limbs, dot, kcfg), x.ring,
                    parties, tag)


def mul_open(x: RSS, y: RSS, parties: Parties, tag: str = "mul_open"):
    """Multiply-and-reveal in ONE round: each P_i broadcasts its masked
    additive z_i (6 elements per slot)."""
    xs, ys = _align_party_axis(x.shares, y.shares)
    z = _mul_parts(xs, ys)
    z = z + parties.zero_shares(z.shape[1:], x.ring)
    comm.record(tag, rounds=1, nbytes=6 * _numel(z.shape[1:]) * x.ring.nbytes)
    return transport.current().open_parts(z)


def matmul_truncate(x: RSS, w: RSS | None, parties: Parties,
                    tag: str = "matmul_tr", w_limbs=None,
                    bias_parts=None, dot=None, kcfg=None) -> RSS:
    """Fused Alg-2 matmul + Π_trunc in ONE online round; ``bias_parts``
    (additive, at the product's 2f scale) rides the opening."""
    ring = x.ring
    z = _matmul_parts(x, w, w_limbs, dot, kcfg)
    if bias_parts is not None:
        z = z + bias_parts
    return _open_shift(z, parties, ring, ring.frac, tag)


def _trunc_pair(shape, parties: Parties, ring: RingSpec, f: int):
    """Offline exact-trunc pair ([r], [r >> f]) with additive shares
    r_i < 2^{l-3}, so the shares of r >> f are the local shifts."""
    r = parties.rand_rss(shape, ring, max_bits=ring.bits - 1)
    return r, RSS(shr(r.shares, f), ring)


def _trunc_decode(c, ring: RingSpec, f: int):
    """Public part of the exact truncation: arithmetic shift of the opened
    c = x + 2^{l-2} − r, minus the offset, plus the +1 bias compensation."""
    return (ring.to_signed(c) >> f) - (1 << (ring.bits - 2 - f)) + 1


def _open_shift(z, parties: Parties, ring: RingSpec, f: int, tag: str) -> RSS:
    """Shared tail of the fused ops: mask the additive parts with the
    bounded trunc pair, broadcast, open, shift.  One round, 6 elements."""
    t = transport.current()
    z = z + parties.zero_shares(z.shape[1:], ring)
    r, rp = _trunc_pair(z.shape[1:], parties, ring, f)
    c_parts = z - t.own_view(r.shares)
    comm.record(tag, rounds=1, nbytes=6 * _numel(z.shape[1:]) * ring.nbytes)
    c = t.open_parts(c_parts) + (1 << (ring.bits - 2))
    return rp.add_public(_trunc_decode(c, ring, f))


def mul_truncate(x: RSS, y: RSS, parties: Parties, frac: int | None = None,
                 tag: str = "mul_tr") -> RSS:
    """Fused elementwise multiply + truncate, one online round."""
    ring = x.ring
    xs, ys = _align_party_axis(x.shares, y.shares)
    return _open_shift(_mul_parts(xs, ys), parties, ring,
                       ring.frac if frac is None else frac, tag)


def square_truncate(x: RSS, parties: Parties, frac: int | None = None,
                    tag: str = "sq_tr") -> RSS:
    ring = x.ring
    return _open_shift(_square_parts(x), parties, ring,
                       ring.frac if frac is None else frac, tag)


# ---------------------------------------------------------------------------
# Convolution = im2col + ring matmul
# ---------------------------------------------------------------------------

def _im2col(x, kh: int, kw: int, stride: int, padding: int):
    """x: (B, H, W, C) -> (B, Ho, Wo, kh*kw*C) patches (pad + strided
    slices: ``F.unfold`` takes no integer tensors)."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    b, h, w, c = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    patches = [x[:, i:i + h - kh + 1:stride, j:j + w - kw + 1:stride, :]
               for i in range(kh) for j in range(kw)]
    return torch.cat(patches, dim=-1), ho, wo


def _im2col_rss(x: RSS, kh, kw, stride, padding):
    p = x.shares.shape[0]
    b, h, w, c = x.shape
    cols, ho, wo = _im2col(x.shares.reshape(p * b, h, w, c),
                           kh, kw, stride, padding)
    cols = cols.reshape((p, b) + tuple(cols.shape[1:]))
    return RSS(cols, x.ring), ho, wo


def _grouped_conv_parts(x: RSS, w: RSS, stride: int, padding: int,
                        groups: int, w_limbs=None):
    """Additive per-channel (depthwise) product stack, fused-operand Alg 2:
    im2col patches contracted against each channel's own kernel.  Returns
    the (S, B, Ho, Wo, Cout) parts stack.  With ``w_limbs`` (a
    GroupedWeightLimbs) the 3-party product is one kernel launch; without
    it the contraction runs in plain torch, on CPU tensors only."""
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    b, cin = x.shape[0], x.shape[3]
    assert groups == cin and cin_g == 1 and cout % groups == 0
    mult = cout // groups
    cols, ho, wo = _im2col_rss(x, kh, kw, stride, padding)
    cols4 = cols.reshape(b, ho, wo, kh * kw, cin)
    t = transport.current()
    if w_limbs is not None:
        from ..kernels.ops import grouped_rss_matmul_op
        z = grouped_rss_matmul_op(t.own_view(cols4.shares), w_limbs)
        return z.reshape(z.shape[0], b, ho, wo, cout)
    _plain_route(x, "depthwise conv")
    slots = t.rss_slots
    ws_full = w.shares.reshape(slots, kh * kw, cin, mult)
    xo, xn = t.own_view(cols4.shares), t.next_view(cols4.shares)
    wo_, wn = t.own_view(ws_full), t.next_view(ws_full)

    def dw(a, bmat):
        # the per-channel contraction as broadcast multiply + sum (torch
        # einsum has no integer path); the sum's int64 wraps back below
        return (a[..., None] * bmat).sum(dim=-3)

    z = torch.stack([dw(xo[i], wo_[i] + wn[i]) + dw(xn[i], wo_[i])
                     for i in range(xo.shape[0])])
    return x.ring.wrap(z).reshape(z.shape[0], b, ho, wo, cout)


def conv2d(x: RSS, w: RSS, parties: Parties, stride: int = 1,
           padding: int = 0, groups: int = 1, tag: str = "conv",
           w_limbs=None, kcfg=None) -> RSS:
    """Secure 2-D convolution, x: (B,H,W,Cin), w: (kh,kw,Cin/groups,Cout);
    dense or depthwise, one reshare round either way (``kcfg`` steers the
    dense kernel; the grouped kernel has no launch choice)."""
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    if groups == 1:
        cols, ho, wo = _im2col_rss(x, kh, kw, stride, padding)
        wmat = w.reshape(kh * kw * cin_g, cout)
        return matmul(cols, wmat, parties, tag=tag, w_limbs=w_limbs,
                      kcfg=kcfg)
    z = _grouped_conv_parts(x, w, stride, padding, groups, w_limbs=w_limbs)
    return _reshare(z, x.ring, parties, tag=tag)


def conv2d_truncate(x: RSS, w: RSS, parties: Parties, stride: int = 1,
                    padding: int = 0, tag: str = "conv_tr", w_limbs=None,
                    bias_parts=None, kcfg=None) -> RSS:
    """Fused conv (groups=1) + bias + Π_trunc, one online round."""
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    cols, ho, wo = _im2col_rss(x, kh, kw, stride, padding)
    wmat = w.reshape(kh * kw * cin_g, cout)
    return matmul_truncate(cols, wmat, parties, tag=tag, w_limbs=w_limbs,
                           bias_parts=bias_parts, kcfg=kcfg)


# ---------------------------------------------------------------------------
# Binary-domain linear engine (DESIGN.md §11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PublicTensor:
    """A PUBLIC model tensor in ring encoding (public-weight deployment):
    no party axis, every party holds the same encoding, so products with
    shares are local.  ``limbs`` carries the setup-time
    ``PublicWeightLimbs`` / ``PublicGroupedLimbs`` kernel cache."""

    enc: torch.Tensor            # ring-encoded public value, int32
    limbs: object | None = None

    @property
    def shape(self):
        return tuple(self.enc.shape)


def bin_matmul(x: RSS, w: RSS | PublicTensor, parties: Parties,
               tag: str = "bin_matmul", w_limbs=None, bias_parts=None,
               bias_public=None, dot=None, kcfg=None) -> RSS:
    """Post-Sign ±1 input (scale 0) times the weights.

    Shared weights (``w: RSS``): the product sits at scale f, so the layer
    is ONE reshare round with the scale-f bias riding the additive parts
    (3 ring elements per output slot).

    Public weights (``w: PublicTensor``): every slot's product
    z_s = x_s @ W is local, so the RSS stack is rebuilt with zero rounds
    and zero bytes (recorded as a 0-cost ledger row); ``bias_public`` is
    added through slot 0.  Without a limb cache the slot products go
    through ``dot`` (or the plain product, CPU only)."""
    if isinstance(w, PublicTensor):
        assert bias_parts is None, \
            "public weights take bias_public, not additive bias_parts"
        comm.record(tag, rounds=0, nbytes=0)
        wl = w.limbs if w_limbs is None else w_limbs
        if wl is not None:
            from ..kernels.ops import bin_rss_matmul_op
            z = bin_rss_matmul_op(x.shares, wl, cfg=kcfg)
        else:
            if dot is None:
                _plain_route(x, "public matmul")
                dot = torch.matmul
            z = torch.stack([dot(x.shares[i], w.enc)
                             for i in range(x.shares.shape[0])])
        out = RSS(z, x.ring)
        return out if bias_public is None else out.add_public(bias_public)
    assert bias_public is None, \
        "shared weights take additive bias_parts, not a public encoding"
    z = _matmul_parts(x, w, w_limbs, dot, kcfg)
    if bias_parts is not None:
        z = z + bias_parts
    return _reshare(z, x.ring, parties, tag)


def _bin_conv2d_public(x: RSS, w: PublicTensor, parties: Parties,
                       stride: int, padding: int, groups: int, tag: str,
                       bias_public, kcfg=None) -> RSS:
    """Public-weight conv: im2col + the public :func:`bin_matmul`, or the
    per-channel contraction against the public depthwise kernel on every
    slot at once; zero communication either way."""
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    cols, ho, wo = _im2col_rss(x, kh, kw, stride, padding)
    if groups == 1:
        wmat = PublicTensor(w.enc.reshape(kh * kw * cin_g, cout), w.limbs)
        return bin_matmul(cols, wmat, parties, tag=tag,
                          bias_public=bias_public, kcfg=kcfg)
    b, cin = x.shape[0], x.shape[3]
    assert groups == cin and cin_g == 1 and cout % groups == 0
    mult = cout // groups
    slots = cols.shares.shape[0]
    cols5 = cols.shares.reshape(slots, b, ho, wo, kh * kw, cin)
    comm.record(tag, rounds=0, nbytes=0)
    if w.limbs is not None:
        from ..kernels.ops import bin_grouped_matmul_op
        z = bin_grouped_matmul_op(cols5, w.limbs)
    else:
        _plain_route(x, "public depthwise conv")
        # the per-channel contraction as broadcast multiply + sum; the
        # sum's int64 wraps back below
        wk = w.enc.reshape(kh * kw, cin, mult)
        z = x.ring.wrap((cols5[..., None] * wk).sum(dim=-3))
    out = RSS(z.reshape(slots, b, ho, wo, cout), x.ring)
    return out if bias_public is None else out.add_public(bias_public)


def bin_conv2d(x: RSS, w: RSS | PublicTensor, parties: Parties,
               stride: int = 1, padding: int = 0, groups: int = 1,
               tag: str = "bin_conv", w_limbs=None, bias_parts=None,
               bias_public=None, kcfg=None) -> RSS:
    """Post-Sign conv: im2col + :func:`bin_matmul`, or the per-channel
    grouped contraction (depthwise half of a sepconv); one reshare round
    with shared weights, none with public weights."""
    if isinstance(w, PublicTensor):
        assert bias_parts is None, \
            "public weights take bias_public, not additive bias_parts"
        return _bin_conv2d_public(x, w, parties, stride, padding, groups,
                                  tag, bias_public, kcfg)
    assert bias_public is None, \
        "shared weights take additive bias_parts, not a public encoding"
    kh, kw, cin_g, cout = (int(d) for d in w.shape)
    if groups != 1:
        z = _grouped_conv_parts(x, w, stride, padding, groups,
                                w_limbs=w_limbs)
        if bias_parts is not None:
            z = z + bias_parts
        return _reshare(z, x.ring, parties, tag=tag)
    cols, ho, wo = _im2col_rss(x, kh, kw, stride, padding)
    wmat = w.reshape(kh * kw * cin_g, cout)
    return bin_matmul(cols, wmat, parties, tag=tag, w_limbs=w_limbs,
                      bias_parts=bias_parts, kcfg=kcfg)


# ---------------------------------------------------------------------------
# Truncation (paper §3.3 Π_trunc, exact statistical-masking variant)
# ---------------------------------------------------------------------------

def truncate(x: RSS, parties: Parties, frac: int | None = None,
             tag: str = "trunc") -> RSS:
    """Divide by 2^f after a fixed-point multiply (DESIGN.md §10): open
    c = (x + 2^{l-2}) − r against the offline pair ([r], [r >> f]), then
    (c >>_a f) + [r >> f] − 2^{l-2-f} + 1.  Requires |x| < 2^{l-3}."""
    ring = x.ring
    f = ring.frac if frac is None else frac
    r, rp = _trunc_pair(x.shape, parties, ring, f)
    c = reveal(x.add_public(1 << (ring.bits - 2)) - r, tag=tag)
    return rp.add_public(_trunc_decode(c, ring, f))


def truncate_probabilistic(x: RSS, parties: Parties, frac: int | None = None,
                           tag: str = "trunc_prob") -> RSS:
    """ABY3 Π_trunc1 with a full-range mask, the paper's citation, kept as
    the reference baseline: ±1 ulp usually, but a catastrophic 2^{l-f}
    error with probability ≈ |x_fixed| / 2^l (DESIGN.md §10)."""
    ring = x.ring
    f = ring.frac if frac is None else frac
    t = transport.current()
    r, r_plain = parties.rand_rss_open(x.shape, ring)
    zero = parties.zero_shares(x.shape, ring)
    rp_parts = _add_slot0(zero, ring.to_signed(r_plain) >> f)
    # the preprocessing reshare that turns the additive [r >> f] into RSS
    comm.record(tag, rounds=1, nbytes=3 * _numel(x.shape) * ring.nbytes,
                preprocess=True)
    rp = RSS(t.complete(rp_parts), ring)
    masked = reveal(x - r, tag=tag)
    return rp.add_public(ring.to_signed(masked) >> f)


# ---------------------------------------------------------------------------
# Algorithm 2: complete linear layer (matmul + bias + trunc)
# ---------------------------------------------------------------------------

def linear_layer(x: RSS, w: RSS | None, b: RSS | None, parties: Parties,
                 truncate_out: bool = True, tag: str = "linear",
                 dot=None, w_limbs=None) -> RSS:
    """z = x @ w + b, truncated back to scale 2^f.  With fused rounds the
    truncation's masked opening rides the matmul's round (1 online round);
    paper-faithful, the reshare and the truncation are 2 rounds."""
    t = transport.current()
    scale = x.ring.scale
    if truncate_out and _FUSED_ROUNDS:
        bias_parts = None
        if b is not None:
            # the product carries scale 2^{2f}: lift the scale-f bias
            bias_parts = t.own_view(b.shares).reshape(
                (t.parts_slots,) + (1,) * (x.ndim - 1) + (-1,)) * scale
        return matmul_truncate(x, w, parties, tag=tag, w_limbs=w_limbs,
                               bias_parts=bias_parts, dot=dot)
    z = matmul(x, w, parties, tag=tag, w_limbs=w_limbs, dot=dot)
    if b is not None:
        bsh = b.shares.reshape((t.rss_slots,) + (1,) * (z.ndim - 1) + (-1,))
        if truncate_out:
            bsh = bsh * scale
        z = RSS(z.shares + bsh, z.ring)
    if truncate_out:
        z = truncate(z, parties, tag=tag + ".trunc")
    return z
