"""Symbolic per-layer cost model + deployment-aware path solver (§15).

Port of ``repro/core/cost_model.py`` (``DeploymentDescriptor`` and the
``local`` / ``lan`` / ``wan`` registry, ``Cost``, ``CostEntry``,
``CostReport``, ``model_cost`` / ``annotate_model``, the attention closed
forms), pure Python like the reference.  Two places differ:

* ``compute_int8_ops`` defaults to the card's dense int8 tensor-core peak
  (the NVIDIA H100 80GB HBM3 at its 700.00 W power limit, as
  ``nvidia-smi --query-gpu=name,power.limit`` reports it: 1,979 TOP/s from
  its datasheet), not the reference's nominal TPU figure.  Parity tests
  that compare the solver's choices pass the reference's figure.
* ``_linear_requests`` lists every launch the port makes: its kernels take
  every shape, where the reference's dispatchers send launches with a
  dimension < 8 to XLA.

Every protocol primitive records its communication (`comm.record`), so a
compiled model's cost is *already* a closed-form function of layer shapes
— this module writes that function down symbolically instead of running
it: rounds, wire bytes and int8 work per layer, as functions of (shape,
ring width, batch, path).  Fidelity is pinned by
tests/test_torch_cost_model.py: for every net in the zoo and every
weight/routing mode, the predicted totals equal the live `CommLedger`
**byte-exactly**, the port's and the reference's.

With the formulas in hand, `compile_secure(..., deployment=...)` stops
using a fixed preference order for the §11 path taxonomy and instead
*solves* for the cheapest assignment per linear layer against a
:class:`DeploymentDescriptor` (link model + batch + compute budget):

    time(op, path) = rounds·latency + bytes/bandwidth + flops/compute

On a WAN the round term dominates and the solver favors fewest-round
paths; on a fast LAN bytes matter more; the "local" descriptor (no
network) degenerates to pure compute.  With no deployment given the
solver minimizes (bytes, rounds, flops) lexicographically — which
reproduces the historical fixed preference order exactly, so existing
path labels (and the tests pinning them) are unchanged.

The same compile step consults the kernel autotuner's persisted cache
(`kernels.autotune`, keyed by the card's name) and attaches the winning
`KernelConfig` per launch as ``op["kcfg"]`` — protocol path and kernel
launch choice are chosen together, at model-setup time, from measured
data.

All formulas below are in *ring elements*; wire bytes multiply by
``ring.nbytes``.  ``n`` is the layer's output numel including batch.
The per-primitive table (verified against core/{linear,msb,activation,
pooling,randomness}.py):

    reshare/mul/truncate  1 round, 3n      mul_open/_open_shift  1 round, 6n
    ot3                   2 rounds, 3n     b2a = ot3 + reshare   3 rounds, 6n
    MSB offline material  4 rounds, 9n  (b2a 6n + rho-mul 3n; fusing-invariant)
    sign   fused 1r/6n    unfused 5r/10n   (+ offline 4r/9n either way)
    relu   fused 2r/9n    unfused 5r/15n   (+ offline 4r/9n)
    maxpool after sign    fused 1r/6n'     unfused 5r/10n'   (n' = pooled numel)
    maxpool generic       3 gated ReLUs on n': fused 6r/27n' unfused 15r/45n'
                          (+ offline 12r/27n')
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..peaks import INT8_OPS
from . import comm
from .linear import fused_rounds

__all__ = ["DeploymentDescriptor", "LOCAL", "LAN", "WAN", "DEPLOYMENTS",
           "resolve_deployment", "Cost", "CostEntry", "CostReport",
           "model_cost", "annotate_model", "trunc_cost", "reveal_cost",
           "mul_trunc_cost", "relu_cost", "relu_attention_cost", "exp_cost",
           "reciprocal_cost", "rsqrt_cost", "rmsnorm_cost",
           "max_lastdim_cost", "softmax_cost", "lm_block_cost",
           "lm_step_cost", "H100_INT8_OPS"]

NB_LIMB_DOTS = (4, 7, 9, 10)  # dots for public limb counts L=1..4 (Σ_{q<L} 4-q)
_SHARE_DOTS = 20              # full 4x4 grid, 10 pairs x 2 fused-identity dots
# dense int8 tensor-core peak of the NVIDIA H100 80GB HBM3 (700.00 W power
# limit), its datasheet figure: the compute term's default
H100_INT8_OPS = INT8_OPS


# ---------------------------------------------------------------------------
# Deployment descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeploymentDescriptor:
    """Where the three parties run: the cost weights the solver uses.

    ``compute_int8_ops`` is the int8 throughput the parties can sustain
    (default: the H100's dense int8 tensor-core peak); the "local"
    descriptor's infinite-bandwidth zero-latency link makes compute the
    only term."""

    name: str
    network: comm.NetworkModel
    batch: int = 1
    compute_int8_ops: float = H100_INT8_OPS
    offline_budget_mb: float | None = None

    def with_batch(self, batch: int) -> "DeploymentDescriptor":
        return dataclasses.replace(self, batch=int(batch))


LOCAL = DeploymentDescriptor(
    "local", comm.NetworkModel("local", 0.0, float("inf")))
LAN = DeploymentDescriptor("lan", comm.LAN)
WAN = DeploymentDescriptor("wan", comm.WAN)

DEPLOYMENTS: dict[str, DeploymentDescriptor] = {
    d.name: d for d in (LOCAL, LAN, WAN)}


def resolve_deployment(dep) -> DeploymentDescriptor | None:
    """None / registry name / descriptor -> descriptor (or None)."""
    if dep is None or isinstance(dep, DeploymentDescriptor):
        return dep
    try:
        return DEPLOYMENTS[str(dep).lower()]
    except KeyError:
        raise ValueError(
            f"unknown deployment {dep!r}; available: "
            + ", ".join(sorted(DEPLOYMENTS))) from None


# ---------------------------------------------------------------------------
# Cost algebra
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cost:
    """Closed-form cost of one (or a sum of) protocol step(s).

    ``rounds``/``nbytes`` are online; ``pre_*`` the offline (preprocessing)
    phase; ``flops`` counts int8 limb MACs·2 at *logical* dims."""

    rounds: int = 0
    nbytes: int = 0
    pre_rounds: int = 0
    pre_nbytes: int = 0
    flops: int = 0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.rounds + o.rounds, self.nbytes + o.nbytes,
                    self.pre_rounds + o.pre_rounds,
                    self.pre_nbytes + o.pre_nbytes, self.flops + o.flops)

    def time(self, dep: DeploymentDescriptor) -> float:
        """Predicted online seconds under a deployment (offline excluded —
        it is path-invariant, so it never affects the argmin)."""
        t = dep.network.time(self.rounds, self.nbytes)
        if self.flops:
            t += self.flops / dep.compute_int8_ops
        return t

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CostEntry:
    idx: int                      # op index in model.ops
    name: str                     # "l0 (conv)", "sign2", "mp5", "output"
    path: Any                     # §11 label (str, or (dw, pw) for sepconv)
    cost: Cost
    engine: bool | None = None    # bin-shared engine choice (linear ops)
    alternatives: dict = dataclasses.field(default_factory=dict)
    requests: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CostReport:
    entries: list
    total: Cost
    deployment: DeploymentDescriptor | None = None
    input_shape: tuple = ()

    @property
    def rounds(self):
        return self.total.rounds

    @property
    def nbytes(self):
        return self.total.nbytes

    @property
    def pre_rounds(self):
        return self.total.pre_rounds

    @property
    def pre_nbytes(self):
        return self.total.pre_nbytes

    @property
    def flops(self):
        return self.total.flops

    def time(self, dep=None) -> float:
        return self.total.time(resolve_deployment(dep) or self.deployment
                               or LAN)

    def kernel_requests(self) -> list:
        """All (family, m, k, n, n_limbs, channels) launches this model
        performs — the exact tuples `kernels.autotune.ensure_tuned` takes."""
        return [r for e in self.entries for r in e.requests]

    def within_offline_budget(self, dep=None) -> bool | None:
        dep = resolve_deployment(dep) or self.deployment
        if dep is None or dep.offline_budget_mb is None:
            return None
        return self.total.pre_nbytes / 1e6 <= dep.offline_budget_mb


# ---------------------------------------------------------------------------
# Shape walk helpers
# ---------------------------------------------------------------------------

def _conv_out_hw(h: int, w: int, k: int, stride: int, pad: int):
    return ((h + 2 * pad - k) // stride + 1,
            (w + 2 * pad - k) // stride + 1)


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _w_shapes(op: dict) -> list[tuple]:
    if "w" in op:
        return [tuple(int(d) for d in w.shape) for w in op["w"]]
    return [tuple(int(d) for d in p.enc.shape) for p in op["pub_w"]]


def _public_limbs(op: dict, part: int) -> int:
    p = op["pub_w"][part]
    if p.limbs is not None:
        return int(p.limbs.n_limbs)
    from ..kernels.bin_rss_matmul import min_public_limbs
    return min_public_limbs(p.enc)


def _model_device(model):
    """The device of a compiled model's weights (the autotune key's)."""
    for op in model.ops:
        for w in op.get("w", ()):
            return w.shares.device
        for p in op.get("pub_w", ()):
            return p.enc.device
    return None


def _dense_flops(m: int, k: int, n: int, limbs: int | None) -> int:
    dots = _SHARE_DOTS if limbs is None else NB_LIMB_DOTS[limbs - 1]
    return 3 * dots * 2 * m * k * n


def _grouped_flops(m: int, k: int, n: int, c: int, limbs: int | None) -> int:
    return _dense_flops(m, k, n, limbs) * c


# ---------------------------------------------------------------------------
# The solver / model walk
# ---------------------------------------------------------------------------

def _linear_candidates(op: dict, shape, nxt_shape, *, public: bool,
                       binary_linear: str, binary_in: bool, nb: int,
                       fused: bool):
    """Per-layer §11 path candidates: (label, engine, Cost) triples, listed
    in the historical preference order so cost ties keep legacy labels.

    Returns (candidates, dw_numel_or_None, mkn metadata)."""
    kind = op["op"]
    batch = int(shape[0])
    ws = _w_shapes(op)
    routed = binary_in and binary_linear != "off"

    if kind == "fc":
        kdim, cout = ws[0]
        m, kk, nn = batch, kdim, cout
        n = batch * cout
        spatial = None
    else:
        kh, kw, cin_g, cout = ws[-1] if kind == "sepconv" else ws[0]
        ho, wo = _conv_out_hw(int(shape[1]), int(shape[2]), op["k"],
                              op["stride"], op["pad"])
        if kind == "sepconv":
            dkh, dkw, _, cin = ws[0]
            m, kk, nn = batch * ho * wo, cin, cout
        else:
            m, kk, nn = batch * ho * wo, kh * kw * cin_g, cout
        n = batch * ho * wo * cout
        spatial = (ho, wo)

    def trunc(count):          # Π_trunc via masked reveal
        return Cost(1, 3 * count * nb)

    def open_fused(count):     # product+trunc in ONE opening (_open_shift)
        return Cost(1, 6 * count * nb)

    def reshare(count):
        return Cost(1, 3 * count * nb)

    if kind != "sepconv":
        limbs = _public_limbs(op, 0) if public else None
        flops = Cost(flops=_dense_flops(m, kk, nn, limbs))
        arith = (open_fused(n) if fused else reshare(n) + trunc(n)) + flops
        if public:
            if routed:
                cands = [("bin-public", None, flops)]
            else:
                cands = [("bin-public+trunc", None, trunc(n) + flops)]
        elif binary_in:
            if binary_linear == "auto":
                cands = [("bin-shared", True, reshare(n) + flops),
                         ("arith", False, reshare(n) + flops)]
            elif binary_linear == "generic":
                cands = [("arith", False, reshare(n) + flops)]
            else:  # "off": lift ±1 to scale f, pay the full opening
                cands = [("arith", None, arith)]
        else:
            cands = [("arith", None, arith)]
        return cands, None, (m, kk, nn, spatial)

    # separable: depthwise (grouped) then pointwise (dense) halves
    ndw = batch * spatial[0] * spatial[1] * ws[0][3]
    dw_limbs = _public_limbs(op, 0) if public else None
    pw_limbs = _public_limbs(op, 1) if public else None
    dwf = Cost(flops=_grouped_flops(m, ws[0][0] * ws[0][1], 1, ws[0][3],
                                    dw_limbs))
    pwf = Cost(flops=_dense_flops(m, kk, nn, pw_limbs))
    pw_arith = (open_fused(n) if fused else reshare(n) + trunc(n)) + pwf
    if public:
        pw = trunc(n) + pwf   # pw input is the dw product at scale f
        if routed:
            cands = [(("bin-public", "bin-public+trunc"), None, dwf + pw)]
        else:
            cands = [(("bin-public+trunc", "bin-public+trunc"), None,
                      dwf + trunc(ndw) + pw)]
    elif binary_in and binary_linear == "auto":
        cands = [(("bin-shared", "arith"), True,
                  reshare(ndw) + dwf + pw_arith),
                 (("arith", "arith"), False,
                  reshare(ndw) + dwf + pw_arith)]
    elif binary_in and binary_linear == "generic":
        cands = [(("arith", "arith"), False,
                  reshare(ndw) + dwf + pw_arith)]
    else:  # arith dw: product at 2f, pay the dwtrunc too
        cands = [(("arith", "arith"), None,
                  reshare(ndw) + trunc(ndw) + dwf + pw_arith)]
    return cands, ndw, (m, kk, nn, spatial)


def _linear_requests(op: dict, m: int, kk: int, nn: int, *,
                     public: bool) -> list:
    """(family, m, k, n, n_limbs, channels) tuples for this op's kernel
    launches: one a weight part, at every shape (the port's kernels take
    them all)."""
    kind = op["op"]
    ws = _w_shapes(op)
    reqs = []
    if kind == "sepconv":
        dkh, dkw, _, cin = ws[0]
        if public:
            reqs.append(("bin_grouped_matmul", m, dkh * dkw, 1,
                         _public_limbs(op, 0), cin))
        else:
            reqs.append(("grouped_rss_matmul", m, dkh * dkw, 1, 4, cin))
        fam = "bin_rss_matmul" if public else "rss_matmul"
        reqs.append((fam, m, kk, nn,
                     _public_limbs(op, 1) if public else 4, None))
    else:
        fam = "bin_rss_matmul" if public else "rss_matmul"
        reqs.append((fam, m, kk, nn,
                     _public_limbs(op, 0) if public else 4, None))
    return reqs


def _lookup_kcfgs(op: dict, reqs: list, cache_path=None,
                  device=None) -> list | None:
    """Autotune-cache lookups aligned with the op's weight parts (sepconv:
    [depthwise, pointwise]); None when nothing is cached."""
    from ..kernels import autotune
    by_family = {}
    for fam, m, kk, nn, limbs, ch in reqs:
        by_family[fam] = autotune.lookup(fam, m, kk, nn, n_limbs=limbs,
                                         channels=ch, path=cache_path,
                                         device=device)
    if op["op"] == "sepconv":
        kcfg = [by_family.get("bin_grouped_matmul")
                or by_family.get("grouped_rss_matmul"),
                by_family.get("bin_rss_matmul")
                or by_family.get("rss_matmul")]
    else:
        kcfg = [by_family.get("bin_rss_matmul")
                or by_family.get("rss_matmul")]
    return kcfg if any(c is not None for c in kcfg) else None


def model_cost(model, input_shape=None, *, deployment=None,
               fused: bool | None = None, stamp: bool = False,
               autotune_cache=None, device=None) -> CostReport:
    """Walk a compiled `SecureModel` symbolically and return its predicted
    cost — byte-exact against the live `CommLedger`
    (tests/test_torch_cost_model.py).

    The walk mirrors `secure_infer`'s dispatch *rules* but evaluates the
    closed-form table instead of tracing: for each linear op it enumerates
    the applicable §11 paths, argmins them under ``deployment`` (or
    lexicographic (bytes, rounds, flops) when None — the historical fixed
    preference order), and with ``stamp=True`` writes the decision back
    onto the op (``path`` / ``engine`` / ``cost`` / ``kcfg``; the cache is
    keyed by ``device``, default the model's).  ``fused`` defaults to the
    active `set_fused_rounds` state."""
    dep = resolve_deployment(deployment)
    if fused is None:
        fused = fused_rounds()
    if input_shape is None:
        from ..nn.bnn import INPUT_SHAPES
        input_shape = ((dep.batch if dep else 1),) + INPUT_SHAPES[model.net]
    shape = tuple(int(d) for d in input_shape)
    if stamp and device is None:
        device = _model_device(model)
    nb = model.ring.nbytes
    public = model.weights == "public"
    binary = False      # §11 domain truth (mirrors _annotate_binary_paths)
    prev_sign = False   # executor's maxpool-fusion state
    entries: list[CostEntry] = []
    total = Cost()

    def pick(cands):
        if dep is not None:
            key = lambda c: c[2].time(dep)
        else:
            key = lambda c: (c[2].nbytes, c[2].rounds, c[2].flops)
        return min(cands, key=key)  # min is stable: ties keep legacy order

    for idx, op in enumerate(model.ops):
        kind = op["op"]
        if kind in ("conv", "sepconv", "fc"):
            binary_in = op.get("binary_in", binary)
            cands, ndw, (m, kk, nn, spatial) = _linear_candidates(
                op, shape, None, public=public,
                binary_linear=model.binary_linear, binary_in=binary_in,
                nb=nb, fused=fused)
            label, engine, cost = pick(cands)
            reqs = _linear_requests(op, m, kk, nn, public=public)
            e = CostEntry(idx, f"l{idx} ({kind})", label, cost,
                          engine=engine,
                          alternatives={str(l): c for l, _, c in cands},
                          requests=reqs)
            entries.append(e)
            total = total + cost
            if stamp:
                op["path"] = label
                if engine is not None:
                    op["engine"] = engine
                op["cost"] = {"path": str(label), **cost.as_dict(),
                              "alternatives": {
                                  str(l): [c.rounds, c.nbytes]
                                  for l, _, c in cands}}
                kcfg = _lookup_kcfgs(op, reqs, cache_path=autotune_cache,
                                     device=device)
                if kcfg is not None:
                    op["kcfg"] = kcfg
            cout = _w_shapes(op)[-1][-1]
            shape = ((shape[0], cout) if kind == "fc"
                     else (shape[0],) + spatial + (cout,))
            binary = False
            prev_sign = False
        elif kind == "sign":
            n = _numel(shape)
            cost = (Cost(1, 6 * n * nb, 4, 9 * n * nb) if fused
                    else Cost(5, 10 * n * nb, 4, 9 * n * nb))
            entries.append(CostEntry(idx, f"sign{idx}", "sign", cost))
            total = total + cost
            binary = True
            prev_sign = True
        elif kind == "relu":
            n = _numel(shape)
            cost = (Cost(2, 9 * n * nb, 4, 9 * n * nb) if fused
                    else Cost(5, 15 * n * nb, 4, 9 * n * nb))
            entries.append(CostEntry(idx, f"relu{idx}", "relu", cost))
            total = total + cost
            binary = False
            prev_sign = False
        elif kind == "affine":
            n = _numel(shape)
            if public:
                cost = Cost(1, 3 * n * nb)
            else:
                cost = Cost(1, 6 * n * nb) if fused else Cost(2, 6 * n * nb)
            entries.append(CostEntry(idx, f"aff{idx}", "affine", cost))
            total = total + cost
            binary = False
            prev_sign = False
        elif kind == "maxpool":
            shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
            nw = _numel(shape)
            if prev_sign:   # §3.6 Sign→MaxPool fusion: one 4-way OR
                cost = (Cost(1, 6 * nw * nb, 4, 9 * nw * nb) if fused
                        else Cost(5, 10 * nw * nb, 4, 9 * nw * nb))
            else:           # 3 gated ReLUs over the pooled numel
                cost = (Cost(6, 27 * nw * nb, 12, 27 * nw * nb) if fused
                        else Cost(15, 45 * nw * nb, 12, 27 * nw * nb))
            entries.append(CostEntry(idx, f"mp{idx}", "maxpool", cost))
            total = total + cost
        elif kind == "flatten":
            shape = (shape[0], _numel(shape[1:]))
    # output opening: every party broadcasts its own share row
    out_cost = Cost(1, 3 * _numel(shape) * nb)
    entries.append(CostEntry(len(model.ops), "output", "reveal", out_cost))
    total = total + out_cost
    return CostReport(entries=entries, total=total, deployment=dep,
                      input_shape=tuple(input_shape))


def annotate_model(model, input_shape=None, *, deployment=None,
                   fused: bool | None = None, autotune_cache=None,
                   device=None) -> CostReport:
    """`model_cost` with ``stamp=True``: the compile-time entry point that
    writes the solved path / engine / cost / kernel config onto each op."""
    return model_cost(model, input_shape, deployment=deployment, fused=fused,
                      stamp=True, autotune_cache=autotune_cache,
                      device=device)


# ---------------------------------------------------------------------------
# Attention-path closed forms (DESIGN.md §16)
# ---------------------------------------------------------------------------
# The transformer/LM serving path composes a different op set than the BNN
# zoo walk above: Newton iterations, the exp ladder, tournament max, the
# ReLU-attention customization.  The reference pins every formula below
# byte-exact against its live CommLedger (tests/test_cost_model.py); the
# port's secure LM path is not ported yet, so tests/test_torch_cost_model.py
# holds these values to the reference's formulas.
#
# All functions take the element count `n` (output numel including batch),
# the ring byte width `nb`, and a `fused` flag defaulting to the active
# `set_fused_rounds` state — mirroring how the protocols themselves branch.


def _fused_arg(fused) -> bool:
    return fused_rounds() if fused is None else fused


def trunc_cost(n: int, nb: int = 4) -> Cost:
    """Π_trunc (masked reveal) on n elements: 1 round, 3n."""
    return Cost(1, 3 * n * nb)


def reveal_cost(n: int, nb: int = 4) -> Cost:
    """Open a shared value to all parties: 1 round, 3n."""
    return Cost(1, 3 * n * nb)


def mul_trunc_cost(n: int, nb: int = 4, fused=None) -> Cost:
    """Secure product (elementwise / matmul / bmm) + truncation on n output
    elements.  Fused: one `_open_shift` opening (1r, 6n); unfused: reshare
    + Π_trunc (2r, 6n).  Same bytes, the fusing saves the round."""
    return (Cost(1, 6 * n * nb) if _fused_arg(fused)
            else Cost(2, 6 * n * nb))


def relu_cost(n: int, nb: int = 4, fused=None) -> Cost:
    """Alg 3+5 secure ReLU (same table as the zoo walk's relu entry)."""
    return (Cost(2, 9 * n * nb, 4, 9 * n * nb) if _fused_arg(fused)
            else Cost(5, 15 * n * nb, 4, 9 * n * nb))


def relu_attention_cost(n: int, nb: int = 4, fused=None) -> Cost:
    """Customized attention ReLU(s)/L on n score elements: one secure ReLU
    + a public fixed-point multiply's truncation."""
    return relu_cost(n, nb, fused) + trunc_cost(n, nb)


def exp_cost(n: int, nb: int = 4, fused=None, k: int = 6) -> Cost:
    """secure_exp: range-reduction truncate + k secure squarings."""
    c = trunc_cost(n, nb)
    for _ in range(k):
        c = c + mul_trunc_cost(n, nb, fused)
    return c


def reciprocal_cost(n: int, nb: int = 4, fused=None,
                    iters: int = 14) -> Cost:
    """Newton reciprocal: 2 mul+trunc per iteration."""
    c = Cost()
    for _ in range(2 * iters):
        c = c + mul_trunc_cost(n, nb, fused)
    return c


def rsqrt_cost(n: int, nb: int = 4, fused=None, iters: int = 14) -> Cost:
    """Newton rsqrt: square + 2 muls per iteration (the ×1/2 rides the
    final shift, so it is byte-free)."""
    c = Cost()
    for _ in range(3 * iters):
        c = c + mul_trunc_cost(n, nb, fused)
    return c


def rmsnorm_cost(n: int, d: int, nb: int = 4, fused=None) -> Cost:
    """secure_rmsnorm over (..., d) with n total elements: square, the 1/d
    averaging truncate on the n/d reduced elements, Newton rsqrt there, and
    the two output multiplies back at full width."""
    nr = n // d
    return (mul_trunc_cost(n, nb, fused) + trunc_cost(nr, nb)
            + rsqrt_cost(nr, nb, fused)
            + mul_trunc_cost(n, nb, fused) + mul_trunc_cost(n, nb, fused))


def max_lastdim_cost(m: int, last: int, nb: int = 4, fused=None) -> Cost:
    """Tournament max over the last dim (m = leading numel): one batched
    gated ReLU per level over m·⌊n/2⌋ elements; odd widths carry the tail."""
    c = Cost()
    n = last
    while n > 1:
        half = n // 2
        c = c + relu_cost(m * half, nb, fused)
        n = half + 1 if n % 2 else half
    return c


def softmax_cost(m: int, last: int, nb: int = 4, fused=None) -> Cost:
    """secure_softmax over (m, last): max tournament, exp ladder on every
    element, Newton reciprocal of the m denominators, final product."""
    return (max_lastdim_cost(m, last, nb, fused)
            + exp_cost(m * last, nb, fused)
            + reciprocal_cost(m, nb, fused)
            + mul_trunc_cost(m * last, nb, fused))


def lm_block_cost(q: int, kv: int, d: int, heads: int, d_ff: int,
                  nb: int = 4, fused=None, customized: bool = True,
                  static_norm: bool = False) -> Cost:
    """One secure decoder block: q query rows attending over kv cached
    positions (q == kv: the full secure_block; q == 1: one decode step
    against a bucket of length kv).  Masking is public structure — free;
    ``static_norm`` (the CBNN norm customization) zeroes the RMSNorm terms."""
    scores = heads * q * kv
    c = Cost() if static_norm else rmsnorm_cost(q * d, d, nb, fused)
    for _ in range(3):                              # wq, wk, wv
        c = c + mul_trunc_cost(q * d, nb, fused)
    c = c + mul_trunc_cost(scores, nb, fused)       # qk bmm
    if customized:
        c = c + relu_attention_cost(scores, nb, fused)
    else:
        c = c + softmax_cost(heads * q, kv, nb, fused)
    c = c + mul_trunc_cost(q * d, nb, fused)        # av bmm
    c = c + mul_trunc_cost(q * d, nb, fused)        # wo
    if not static_norm:
        c = c + rmsnorm_cost(q * d, d, nb, fused)
    c = c + mul_trunc_cost(q * d_ff, nb, fused)     # up
    c = c + relu_cost(q * d_ff, nb, fused)
    c = c + mul_trunc_cost(q * d, nb, fused)        # down
    return c


def lm_step_cost(bucket: int, d: int, heads: int, d_ff: int, n_blocks: int,
                 vocab: int, nb: int = 4, fused=None,
                 customized: bool = True, static_norm: bool = False) -> Cost:
    """One full secure decode step (= comm per generated token): the token
    embedding gather is local (public index), every block attends over the
    bucket, then final norm + LM head + the logits opening."""
    c = Cost()
    for _ in range(n_blocks):
        c = c + lm_block_cost(1, bucket, d, heads, d_ff, nb, fused,
                              customized, static_norm)
    if not static_norm:
        c = c + rmsnorm_cost(d, d, nb, fused)
    c = c + mul_trunc_cost(vocab, nb, fused)        # LM head
    c = c + reveal_cost(vocab, nb)                  # public logits
    return c
