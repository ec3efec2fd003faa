"""CBNN protocols on a transformer block, and secure LM serving.

Port of ``repro/core/secure_transformer.py`` on the local transport:
``SecureBlockParams`` / ``share_block_params``, ``secure_block``, ``_bmm``,
``plaintext_block``, ``SecureKVCache`` / ``init_kv_cache`` (3 additive
slots), ``SecureLMParams`` / ``share_lm_params``, ``secure_decode_step``,
``scan_prefill``, ``secure_prefill``, ``CompiledDecodeStep``,
``plaintext_lm_forward`` and ``block_comm_profile``.  The same seeds give
the reference's shares, logits, KV cache and ledger rows bit for bit.
``make_secure_lm_mesh`` (the party-per-device step) is ROADMAP item A7.

The customization recipe carried to the LM (DESIGN.md §4/§16): every linear
is an Alg-2 RSS matmul fused with Π_trunc, the attention softmax is replaced
by ReLU(s)/L, the FFN activation is secure ReLU, and RMSNorm runs on the
Newton-rsqrt substrate; the un-customized mode (full secure softmax) is kept
for comparison, and ``static_norm`` folds the norms into the adjacent
linears at setup (zero online rounds).

On the card the products run on the port's kernels only.  Each weight
linear reads the ``WeightLimbs`` cache that ``share_block_params`` /
``share_lm_params`` build beside the shares when the device is the card
(B1, ``rss_matmul``; as ``compile_secure`` caches a classifier's limbs),
and a linear without that cache raises there.  The share x share attention
products (``_bmm``) run on B5's batched entry, one launch for every
(party, head) of a product.

Decode (DESIGN.md §16): :class:`SecureKVCache` holds every block's K/V
projections as RSS share stacks, ``(3, n_blocks, n_heads, bucket,
head_dim)``.  :func:`secure_decode_step` runs one token through every block
and writes cache row ``pos`` in place (the reference returns a new array;
writing in place saves a copy of the cache a step, and the returned cache
is the same object).  Its protocol randomness comes from
``Parties(fold_in(keys, pos))``, so a prefill over the prompt and a
token-by-token decode draw the same PRF streams at every position:
prefill-then-decode equals the full prefill bit for bit.  The step runs
eagerly.  The PRF keys are host-side integers derived per position, so a
CUDA graph captured at one position would replay that position's masks at
every other one; :class:`CompiledDecodeStep` keeps the reference's
one-build-per-bucket contract without one.

Generated tokens are public by functionality: each step reveals the logits,
the argmax is public, and the next embedding row is a local gather on the
shared table (zero rounds).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import prf, telemetry, transport
from .activation import secure_relu
from .comm import estimate_cost
from .linear import (_open_shift, _reshare, fused_rounds, matmul,
                     matmul_truncate, reveal, set_fused_rounds,
                     set_matmul_mode, truncate)
from .norm import _f32, secure_rmsnorm
from .randomness import Parties
from .ring import RingSpec, default_ring
from .rss import RSS, share
from .softmax import relu_attention_scores, secure_softmax
from ..device import resolve_device
from ..kernels.ops import ring_matmul_batched_op
from ..kernels.rss_matmul import precompute_weight_limbs

__all__ = ["SecureBlockParams", "share_block_params", "secure_block",
           "plaintext_block", "SecureKVCache", "init_kv_cache",
           "SecureLMParams", "share_lm_params", "secure_decode_step",
           "scan_prefill", "secure_prefill", "CompiledDecodeStep",
           "make_secure_lm_mesh", "plaintext_lm_forward",
           "block_comm_profile", "WEIGHT_LINEARS"]

# the weight linears of a block, in SecureBlockParams' field order
WEIGHT_LINEARS = ("wq", "wk", "wv", "wo", "w_up", "w_down")


@dataclasses.dataclass
class SecureBlockParams:
    """One decoder block's shares; ``limbs`` maps each weight linear to its
    ``WeightLimbs`` kernel cache (built on the card; ``None`` on the CPU,
    where the plain products run)."""

    wq: RSS
    wk: RSS
    wv: RSS
    wo: RSS
    w_up: RSS
    w_down: RSS
    g1: RSS
    g2: RSS
    n_heads: int
    head_dim: int
    limbs: dict | None = None

    _FIELDS = WEIGHT_LINEARS + ("g1", "g2")

    def lim(self, name: str):
        return None if self.limbs is None else self.limbs[name]


def share_block_params(key: prf.Key, d: int, n_heads: int, d_ff: int,
                       ring: RingSpec | None = None,
                       numpy_params: dict | None = None, device=None):
    """Model-owner setup: create (or take) plaintext weights and share them
    on ``device`` (the card unless ``"cpu"``); on the card each weight
    linear also gets its ``WeightLimbs`` cache.  Returns
    ``(SecureBlockParams, plain numpy dict)``."""
    ring = ring or default_ring()
    device = resolve_device(device)
    hd = d // n_heads
    rng = np.random.default_rng(0)
    p = numpy_params or {
        "wq": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
        "wk": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
        "wv": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
        "wo": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
        "w_up": rng.normal(0, 1 / math.sqrt(d), (d, d_ff)).astype(np.float32),
        "w_down": rng.normal(0, 1 / math.sqrt(d_ff),
                             (d_ff, d)).astype(np.float32),
        "g1": np.ones((d,), np.float32),
        "g2": np.ones((d,), np.float32),
    }
    ks = prf.split(key, 8)
    shared_p = dict(p)
    # fold the 1/√hd attention scale into W_q at setup, in numpy float32 as
    # the reference does (a 3f-scaled product would overflow the ring)
    shared_p["wq"] = p["wq"] / math.sqrt(hd)
    sh = {k: share(torch.as_tensor(v, device=device), kk, ring)
          for (k, v), kk in zip(shared_p.items(), ks)}
    lm = ({k: precompute_weight_limbs(sh[k].shares) for k in WEIGHT_LINEARS}
          if device.type == "cuda" else None)
    return SecureBlockParams(n_heads=n_heads, head_dim=hd, limbs=lm,
                             **sh), p


def _lin(inp: RSS, w: RSS, parties: Parties, t: str, w_limbs=None) -> RSS:
    """A weight linear with its truncation: one round fused, two not."""
    if fused_rounds():
        return matmul_truncate(inp, w, parties, tag=t, w_limbs=w_limbs)
    return truncate(matmul(inp, w, parties, tag=t, w_limbs=w_limbs), parties,
                    tag=t + ".tr")


def secure_block(x: RSS, bp: SecureBlockParams, parties: Parties,
                 customized: bool = True, static_norm: bool = False,
                 tag: str = "blk") -> RSS:
    """One decoder block under RSS, x: (S, d) one sequence.

    customized=True: ReLU-attention (the paper's recipe); False: the full
    secure softmax.  static_norm=True: RMSNorm replaced by a static scale
    the owner folds into the next linear (zero online rounds)."""
    ring = x.ring
    s = int(x.shape[0])
    h, hd = bp.n_heads, bp.head_dim
    d = h * hd

    def lin(inp, name, t):
        return _lin(inp, getattr(bp, name), parties, t, bp.lim(name))

    def norm(v, g, t):
        if static_norm:
            return v   # folded into the following linear at setup
        return secure_rmsnorm(v, g, parties, tag=t)

    hin = norm(x, bp.g1, tag + ".norm1")
    q = lin(hin, "wq", tag + ".wq")
    k = lin(hin, "wk", tag + ".wk")
    v = lin(hin, "wv", tag + ".wv")

    # per-head scores (h, S, S); the 1/√hd scale is folded into W_q
    qh = q.reshape(s, h, hd).transpose((1, 0, 2))   # (h, S, hd)
    kh = k.reshape(s, h, hd).transpose((1, 2, 0))   # (h, hd, S)
    scores = _bmm(qh, kh, parties, tag=tag + ".qk", fuse_trunc=True)

    # causal mask: public structure, the parties zero the upper triangle
    mask = torch.tril(torch.ones((s, s), dtype=ring.dtype,
                                 device=x.device))
    if customized:
        probs = relu_attention_scores(scores, s, parties,
                                      tag=tag + ".reluattn")
        probs = RSS(probs.shares * mask, ring)
    else:
        neg = ring.encode(_f32(-16.0)).to(x.device)
        masked = RSS(scores.shares * mask, ring).add_public(
            torch.where(mask == 0, neg, torch.zeros_like(mask)))
        probs = secure_softmax(masked, parties, tag=tag + ".softmax")

    vh = v.reshape(s, h, hd).transpose((1, 0, 2))   # (h, S, hd)
    ctx = _bmm(probs, vh, parties, tag=tag + ".av", fuse_trunc=True)
    ctx = ctx.transpose((1, 0, 2)).reshape(s, d)
    x = x + lin(ctx, "wo", tag + ".wo")

    hin2 = norm(x, bp.g2, tag + ".norm2")
    up = lin(hin2, "w_up", tag + ".up")
    act = secure_relu(up, parties, tag=tag + ".relu")
    return x + lin(act, "w_down", tag + ".down")


def _bmm(a: RSS, b: RSS, parties: Parties, tag: str,
         fuse_trunc: bool = False) -> RSS:
    """Batched secure matmul over a leading head axis, (h, S, K) x
    (h, K, T), optionally with the one-round fused truncation.

    Per party z_i = x_i·(y_i + y_{i+1}) + x_{i+1}·y_i, written as one
    product with K doubled: [x_i | x_{i+1}] · [y_i + y_{i+1}; y_i].  Every
    (party, head) product of it is one batch entry of B5's batched kernel
    (one launch; the plain batched matmul on CPU tensors)."""
    ring = a.ring
    t = transport.current()
    xs, ys = t.own_view(a.shares), t.own_view(b.shares)
    xn, yn = t.next_view(a.shares), t.next_view(b.shares)
    z = ring_matmul_batched_op(torch.cat([xs, xn], dim=-1),
                               torch.cat([ys + yn, ys], dim=-2))
    if not fuse_trunc:
        return _reshare(z, ring, parties, tag)
    if not fused_rounds():
        return truncate(_reshare(z, ring, parties, tag), parties,
                        tag=tag + ".tr")
    # fused: broadcast the masked additive parts, open, shift (1 round)
    return _open_shift(z, parties, ring, ring.frac, tag + ".fused")


def plaintext_block(x, p, n_heads: int, customized: bool = True,
                    static_norm: bool = False):
    """fp32 oracle matching secure_block's computation graph (numpy)."""
    s, d = x.shape
    hd = d // n_heads

    def rms(v, g):
        if static_norm:
            return v
        return v / np.sqrt((v * v).mean(-1, keepdims=True) + 1e-5) * g

    hin = rms(x, p["g1"])
    q = (hin @ p["wq"]).reshape(s, n_heads, hd).transpose(1, 0, 2)
    k = (hin @ p["wk"]).reshape(s, n_heads, hd).transpose(1, 0, 2)
    v = (hin @ p["wv"]).reshape(s, n_heads, hd).transpose(1, 0, 2)
    scores = q @ k.transpose(0, 2, 1) / math.sqrt(hd)
    mask = np.tril(np.ones((s, s)))
    if customized:
        probs = np.maximum(scores, 0) / s * mask[None]
    else:
        sm = np.where(mask[None] > 0, scores, -16.0)
        e = np.exp(sm - sm.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
    ctx = (probs @ v).transpose(1, 0, 2).reshape(s, d)
    x = x + ctx @ p["wo"]
    hin2 = rms(x, p["g2"])
    ffn = np.maximum(hin2 @ p["w_up"], 0) @ p["w_down"]
    return x + ffn


# ---------------------------------------------------------------------------
# Autoregressive LM serving (DESIGN.md §16)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecureKVCache:
    """RSS-shared K/V cache of every block: ``k`` / ``v`` of shape
    ``(3, n_blocks, n_heads, bucket, head_dim)`` in the ring dtype, the 3
    additive slots of the local transport.  Unwritten rows are exact ring
    zeros, so scores against them are exactly 0 before masking."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def bucket(self) -> int:
        return self.k.shape[3]


def init_kv_cache(n_blocks: int, n_heads: int, head_dim: int, bucket: int,
                  ring: RingSpec | None = None, slots: int = 3,
                  device=None) -> SecureKVCache:
    """A zero cache on ``device`` (the card unless ``"cpu"``).  Only the
    local transport's 3 slots: the mesh's 6-slot pair layout is ROADMAP
    item A7."""
    if slots != 3:
        raise NotImplementedError(
            f"a {slots}-slot cache is the mesh backend's pair layout "
            f"(ROADMAP item A7); the port has the local transport's 3 slots")
    ring = ring or default_ring()
    device = resolve_device(device)
    shape = (slots, n_blocks, n_heads, bucket, head_dim)
    return SecureKVCache(torch.zeros(shape, dtype=ring.dtype, device=device),
                         torch.zeros(shape, dtype=ring.dtype, device=device))


@dataclasses.dataclass
class SecureLMParams:
    """A whole decoder LM under RSS: the embedding table, the blocks, the
    final norm and the LM head; ``w_out_limbs`` is the head's kernel
    cache (on the card)."""

    embed: RSS                     # (vocab, d)
    blocks: tuple                  # of SecureBlockParams
    gf: RSS                        # (d,)
    w_out: RSS                     # (d, vocab)
    vocab: int = 0
    w_out_limbs: object = None

    @property
    def n_heads(self) -> int:
        return self.blocks[0].n_heads

    @property
    def head_dim(self) -> int:
        return self.blocks[0].head_dim

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def d_model(self) -> int:
        return self.n_heads * self.head_dim


def share_lm_params(key: prf.Key, vocab: int, d: int, n_heads: int,
                    d_ff: int, n_blocks: int, ring: RingSpec | None = None,
                    device=None):
    """Model-owner setup for the LM: the reference's deterministic plaintext
    weights (numpy ``default_rng(7)``, scaled so every intermediate stays
    inside the Newton / bound envelopes of the fixed point) and their RSS
    sharing under the same key splits, on ``device`` (the card unless
    ``"cpu"``; there every weight linear also gets its ``WeightLimbs``
    cache).  Returns ``(SecureLMParams, plain_dict)``; the dict drives the
    fp32 oracle."""
    ring = ring or default_ring()
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    blocks, plain_blocks = [], []
    keys = prf.split(key, n_blocks + 3)
    for i in range(n_blocks):
        p = {
            "wq": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
            "wk": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
            "wv": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
            "wo": rng.normal(0, 1 / math.sqrt(d), (d, d)).astype(np.float32),
            "w_up": rng.normal(0, 1 / math.sqrt(d),
                               (d, d_ff)).astype(np.float32),
            "w_down": rng.normal(0, 1 / math.sqrt(d_ff),
                                 (d_ff, d)).astype(np.float32),
            "g1": np.ones((d,), np.float32),
            "g2": np.ones((d,), np.float32),
        }
        bp, _ = share_block_params(keys[i], d, n_heads, d_ff, ring,
                                   numpy_params=p, device=device)
        blocks.append(bp)
        plain_blocks.append(p)
    embed = rng.normal(0, 0.5, (vocab, d)).astype(np.float32)
    gf = np.ones((d,), np.float32)
    w_out = rng.normal(0, 1 / math.sqrt(d), (d, vocab)).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=device)
    w_out_sh = share(on(w_out), keys[-1], ring)
    lm = SecureLMParams(
        embed=share(on(embed), keys[-3], ring), blocks=tuple(blocks),
        gf=share(on(gf), keys[-2], ring), w_out=w_out_sh, vocab=vocab,
        w_out_limbs=(precompute_weight_limbs(w_out_sh.shares)
                     if device.type == "cuda" else None))
    plain = {"embed": embed, "blocks": plain_blocks, "gf": gf,
             "w_out": w_out}
    return lm, plain


def secure_decode_step(lm: SecureLMParams, cache: SecureKVCache, tok: int,
                       pos: int, keys, customized: bool = True,
                       static_norm: bool = False, tag: str = "lm",
                       positions: torch.Tensor | None = None):
    """One token through every block; cache row ``pos`` written in place.
    Returns ``(logits (vocab,), cache)``.

    The protocol randomness comes from ``Parties(fold_in(keys, pos))``, so a
    prefill and the per-token decode loop draw the same PRF streams at
    every position.  The step reveals the logits (the functionality's
    public output); the token's choice is public.  ``static_norm``: the
    norms folded into the adjacent linears at setup (zero online rounds).
    ``positions`` is the bucket's ``arange`` on the device
    (:class:`CompiledDecodeStep` makes it once per bucket)."""
    ring = lm.embed.ring
    dev = lm.embed.shares.device
    pos, tok = int(pos), int(tok)
    parties = Parties([prf.fold_in(k, pos) for k in keys], device=dev)
    h, hd = lm.n_heads, lm.head_dim
    d = h * hd
    bucket = cache.bucket
    if positions is None:
        positions = torch.arange(bucket, device=dev)
    valid = positions <= pos

    # the token's embedding: a public index into the shared table, a local
    # gather (zero rounds, zero bytes)
    x = RSS(lm.embed.shares[:, tok].unsqueeze(1), ring)

    def norm(v, g, t):
        if static_norm:
            return v   # folded into the following linear at setup
        return secure_rmsnorm(v, g, parties, tag=t)

    ck, cv = cache.k, cache.v
    for i, bp in enumerate(lm.blocks):
        bt = f"{tag}.b{i}"

        def lin(inp, name, t):
            return _lin(inp, getattr(bp, name), parties, t, bp.lim(name))

        hin = norm(x, bp.g1, bt + ".norm1")
        q = lin(hin, "wq", bt + ".wq")
        k = lin(hin, "wk", bt + ".wk")
        v = lin(hin, "wv", bt + ".wv")

        qh = q.reshape(1, h, hd).transpose((1, 0, 2))   # (h, 1, hd)
        # write row `pos` of this block's cache: share-local updates
        ck[:, i, :, pos] = k.shares.reshape(-1, h, hd)
        cv[:, i, :, pos] = v.shares.reshape(-1, h, hd)
        K = RSS(ck[:, i], ring)                          # (h, bucket, hd)
        V = RSS(cv[:, i], ring)

        scores = _bmm(qh, K.transpose((0, 2, 1)), parties, tag=bt + ".qk",
                      fuse_trunc=True)                   # (h, 1, bucket)
        vmask = valid.to(ring.dtype)
        if customized:
            probs = relu_attention_scores(scores, bucket, parties,
                                          tag=bt + ".reluattn")
            probs = RSS(probs.shares * vmask, ring)
        else:
            neg = ring.encode(_f32(-16.0)).to(dev)
            masked = RSS(scores.shares * vmask, ring).add_public(
                torch.where(valid, torch.zeros_like(neg), neg))
            probs = secure_softmax(masked, parties, tag=bt + ".softmax")

        ctx = _bmm(probs, V, parties, tag=bt + ".av", fuse_trunc=True)
        ctx = ctx.transpose((1, 0, 2)).reshape(1, d)
        x = x + lin(ctx, "wo", bt + ".wo")

        hin2 = norm(x, bp.g2, bt + ".norm2")
        up = lin(hin2, "w_up", bt + ".up")
        act = secure_relu(up, parties, tag=bt + ".relu")
        x = x + lin(act, "w_down", bt + ".down")

    xf = norm(x, lm.gf, tag + ".normf")
    logits = _lin(xf, lm.w_out, parties, tag + ".head",
                  lm.w_out_limbs)                       # (1, vocab)
    out = reveal(logits, tag=tag + ".logits", decode=True)
    return out[0], cache


def scan_prefill(step, cache: SecureKVCache, tokens, keys):
    """Prefill by running a ``(cache, tok, pos, keys) -> (logits, cache)``
    step over the prompt in order (the reference's ``lax.scan``, here a
    loop).  Works with the local step or a :class:`CompiledDecodeStep`'s
    ``raw`` body.  Returns ``(logits (T, vocab), cache)``."""
    logits = []
    for p, t in enumerate(np.asarray(tokens).reshape(-1).tolist()):
        lg, cache = step(cache, int(t), p, keys)
        logits.append(lg)
    return torch.stack(logits), cache


def secure_prefill(lm: SecureLMParams, cache: SecureKVCache, tokens, keys,
                   customized: bool = True, static_norm: bool = False,
                   tag: str = "lm"):
    """Secure prefill whose step IS ``secure_decode_step``, so
    prefill-then-decode and a pure decode loop compute bit-identical
    logits and cache at every position."""

    def step(c, t, p, ks):
        return secure_decode_step(lm, c, t, p, ks, customized, static_norm,
                                  tag)

    return scan_prefill(step, cache, tokens, keys)


class CompiledDecodeStep:
    """The decode step, built once per padded bucket length.

    The reference jits the step and counts its traces; the port runs it
    eagerly (no CUDA graph: the per-position PRF keys are host-side, and a
    captured graph would replay one position's masks at every position).
    A build makes the bucket's constants on the device (the position range
    that masks the cache) and binds them to the step; ``traces`` counts
    builds, so serving can assert one per bucket.  ``raw`` is the uncounted
    body (``raw(cache, tok, pos, keys)``), what a prefill loop runs.  The
    reference's ``step_fn`` (the mesh step) is ROADMAP item A7's."""

    def __init__(self, lm: SecureLMParams, customized: bool = True,
                 static_norm: bool = False, tag: str = "lm", bucket=None):
        self.traces = 0
        self.bucket = bucket   # padded bucket length (telemetry label)
        self._built = {}

        def raw(cache, tok, pos, keys, positions=None):
            return secure_decode_step(lm, cache, tok, pos, keys, customized,
                                      static_norm, tag, positions=positions)
        self.raw = raw

    def __call__(self, cache: SecureKVCache, tok: int, pos: int, keys):
        key = (cache.bucket, str(cache.k.device))
        built = key in self._built
        if not built:
            self.traces += 1
            self._built[key] = torch.arange(cache.bucket,
                                            device=cache.k.device)

        def run():
            return self.raw(cache, tok, pos, keys,
                            positions=self._built[key])
        if not telemetry.enabled():   # disabled: no clock, no span
            return run()
        b = self.bucket if self.bucket is not None else "?"
        with telemetry.span(f"decode_step[b{b}]", cat="online",
                            lane="parties") as s:
            out = run()
        if not built and s is not None:
            s.name, s.cat = f"decode_compile[b{b}]", "compile"
        return out


def make_secure_lm_mesh(*args, **kwargs):
    """The party-per-device decode step: ROADMAP item A7."""
    raise NotImplementedError(
        "make_secure_lm_mesh is the mesh backend (ROADMAP item A7); the port "
        "serves the LM on the local transport")


def plaintext_lm_forward(plain: dict, tokens, n_heads: int,
                         customized: bool = True, bucket: int | None = None,
                         static_norm: bool = False):
    """fp32 LM oracle matching the secure decode's bucket-padded graph:
    K/V padded with zeros to ``bucket``, causal validity mask,
    ReLU-attention normalised by the static bucket length (or −16-masked
    softmax).  Returns logits ``(T, vocab)`` (numpy)."""
    tokens = np.asarray(tokens)
    emb = plain["embed"][tokens]                      # (T, d)
    T, d = emb.shape
    S = bucket or T
    hd = d // n_heads

    def rms(v, g):
        if static_norm:
            return v
        return v / np.sqrt((v * v).mean(-1, keepdims=True) + 1e-5) * g

    valid = np.arange(S)[None, :] <= np.arange(T)[:, None]   # (T, S)
    x = emb
    for p in plain["blocks"]:
        hin = rms(x, p["g1"])
        q = (hin @ p["wq"]).reshape(T, n_heads, hd).transpose(1, 0, 2)
        k = (hin @ p["wk"]).reshape(T, n_heads, hd).transpose(1, 0, 2)
        v = (hin @ p["wv"]).reshape(T, n_heads, hd).transpose(1, 0, 2)
        kp = np.zeros((n_heads, S, hd), np.float32)
        vp = np.zeros((n_heads, S, hd), np.float32)
        kp[:, :T], vp[:, :T] = k, v
        scores = q @ kp.transpose(0, 2, 1) / math.sqrt(hd)    # (h, T, S)
        if customized:
            probs = np.maximum(scores, 0) / S * valid[None]
        else:
            sm = np.where(valid[None], scores, -16.0)
            e = np.exp(sm - sm.max(-1, keepdims=True))
            probs = e / e.sum(-1, keepdims=True)
        ctx = (probs @ vp).transpose(1, 0, 2).reshape(T, d)
        x = x + ctx @ p["wo"]
        hin2 = rms(x, p["g2"])
        x = x + np.maximum(hin2 @ p["w_up"], 0) @ p["w_down"]
    return rms(x, plain["gf"]) @ plain["w_out"]


def block_comm_profile(seq: int = 16, d: int = 64, heads: int = 4,
                       d_ff: int = 128):
    """§Perf measurement helper: variant -> ledger of one secure_block
    across the protocol optimisation ladder (shape-only runs).  The
    reference leaves the rounds toggle off afterwards; the port restores
    both toggles as it found them."""
    from . import linear

    bp, _ = share_block_params(prf.PRNGKey(0), d, heads, d_ff, device="cpu")
    xs = share(torch.zeros((seq, d)), prf.PRNGKey(1))
    out = {}
    variants = [
        ("paper_softmax", dict(customized=False), False, "paper3"),
        ("paper_softmax_opt2", dict(customized=False), False, "opt2"),
        ("customized", dict(customized=True), False, "opt2"),
        ("customized_fused", dict(customized=True), True, "opt2"),
        ("customized_fused_staticnorm",
         dict(customized=True, static_norm=True), True, "opt2"),
    ]
    was = (linear.fused_rounds(), linear._MATMUL_MODE)
    try:
        for name, kw, fused, mode in variants:
            set_fused_rounds(fused)
            set_matmul_mode(mode)
            out[name] = estimate_cost(
                lambda s_, b_: secure_block(
                    s_, b_, Parties.setup(prf.PRNGKey(9), device="meta"),
                    **kw), xs, bp)
    finally:
        set_fused_rounds(was[0])
        set_matmul_mode(was[1])
    return out
