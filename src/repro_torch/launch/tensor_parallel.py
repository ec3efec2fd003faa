"""Tensor- and sequence-parallel compute over a plan's "model" axis.

The reference gets this from XLA: ``repro/launch/dryrun.py:69-91`` jits
the train, prefill and decode steps with ``in_shardings`` from
``param_specs`` and ``cache_specs``, and GSPMD splits every column- and
row-sharded product over "model"; ``repro/nn/transformer.py:207,216``
keeps the residual stream sharded over the sequence between layers
(``shard_hint(h, "batch", "seq", None)``, "seq" -> "model" in
``launch/context.py``) and ``:225``, ``:258`` keep the logits sharded over
the vocabulary.  The port writes the same program out by hand
(Megatron-style sequence parallelism) on plain local tensors:

* :func:`local_params` replaces every parameter of the ``LM`` by its
  storage shard (the DTensor's local tensor, split over "data" / "pod"
  and "model") and makes the tensor-parallel plan the one in use;
  :func:`gathered` then takes one layer's (or the embedding's, the
  head's) "model" shards for the code inside it, gathered over "data"
  and "pod" (FSDP storage gathered per layer, the reference's
  ``repro/launch/mesh.py:5-6``, ``repro/nn/transformer.py:207-219``: one
  layer's gathered weights live at a time, and a layer recomputed under
  remat gathers them again); in backward each leaf's gradient
  reduce-scatters back to its storage shard over "data" (a leaf whole
  over "data", such as a norm's, all-reduces), so it leaves the step
  already summed over the data ranks;
* the residual stream between layers is this rank's slice of the
  sequence (``S / m`` positions of its data shard) where ``m`` divides S
  (``TPState.sp``); else (a decode step's one token) it is whole on every
  rank of the row, and :func:`enter` / :func:`leave` reduce to
  :func:`copy_to_model` / :func:`reduce_from_model`;
* a tensor-parallel layer enters with :func:`enter` (the sequence
  all-gathered; in backward its cotangents reduce-scattered), runs its
  column products on the local columns (q heads, FFN columns, Mamba-2
  heads, experts) and leaves with :func:`leave` (the row product's
  float32 partial sums reduce-scattered over the sequence; in backward
  all-gathered);
* a weight whose storage split does not line up with the layer's heads
  (MLA's latent projections, Mamba-2's fused ``w_in`` and ``conv_w``) is
  taken whole in train and prefill (:func:`whole`: gathered, its
  gradient reduce-scattered back) and cut to the rank's columns
  (:func:`block`); in decode the token's products are gathered instead
  (:func:`columns`: an activation, never a weight);
* decode attends over the cache's sequence slice (``cache_specs``: S/m
  positions a rank) for every head and combines the softmax over "model"
  (:func:`softmax_combine`: one max and one sum);
* GQA heads that ``m`` does not divide run unevenly (rank j the heads
  ``[jH/m, (j+1)H/m)``, ``wq`` and ``wo`` gathered whole in bf16 and cut
  at head boundaries); MLA's naive decode expands the rank's S/m latent
  positions with ``w_uk`` / ``w_uv`` gathered whole in bf16; a layer
  whose FFN columns, experts, MLA or Mamba-2 heads ``m`` does not divide
  (no model of the zoo at m = 16) raises: no layer runs whole;
* norms run on the sequence slice; their weights pass :func:`on_shard`
  (identity, their gradient all-reduced over "model" in backward).

Every collective is a c10d op on the plan's "model" group inside a
``torch.autograd.Function`` whose backward is the conjugate: all-gather
<-> reduce-scatter, identity <-> all-reduce, slice <-> all-gather.  A
CUDA tensor crosses a gloo group as a host copy (:func:`on_group`, the
one route for every collective of the port's mesh code; torch's
functional collectives crash the ranks on CUDA tensors over gloo).  With
every leaf's gradient complete for its "model" shard, the gather's
backward sums it over "data" (``launch.steps._mesh_grads``).

The state in use is a module global, not a context variable: remat
(``torch.utils.checkpoint``) recomputes a layer inside the backward pass,
which runs CUDA work on the autograd engine's own thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types

import torch

__all__ = ["TPState", "current", "local_params", "gathered", "on_group",
           "copy_to_model", "reduce_from_model", "gather_seq", "scatter_seq",
           "reduce_scatter_seq", "gather_model", "enter", "leave",
           "enter_whole", "leave_whole", "on_shard", "sliced", "split",
           "whole", "max_over_model",
           "sum_over_model", "softmax_combine", "columns", "block",
           "stream_len", "reduced"]


@dataclasses.dataclass
class TPState:
    """The tensor-parallel plan in use: the "model" group, its size ``m``
    and this rank's index ``j`` in it, whether the stream is sequence-
    sharded (``sp``), each leaf's "model" dim (by ``id``, the storage
    shards' and those :func:`gathered` gives; None where the leaf is
    whole).  ``storage`` holds the mesh axes other than
    "model" with more than one rank ((group, size) each, mesh order),
    ``shards`` each storage shard's dim along each of them (by ``id``;
    None where the leaf is whole over it), and ``reduced`` the storage
    shards whose gradient a gather's backward sums over them."""
    group: object
    m: int
    j: int
    sp: bool
    dims: dict
    storage: tuple = ()
    shards: dict = dataclasses.field(default_factory=dict)
    reduced: set = dataclasses.field(default_factory=set)


_STATE: TPState | None = None
_STORE: TPState | None = None      # the state whose storage is gathered


def current() -> TPState | None:
    return _STATE


@contextlib.contextmanager
def _use(state):
    global _STATE
    prev, _STATE = _STATE, state
    try:
        yield state
    finally:
        _STATE = prev


def stream_len(batch: dict, cfg) -> int:
    """The residual stream's sequence length of a batch: the frames, or
    the patch slots and the text."""
    if cfg.frontend == "audio":
        return batch["frames"].shape[1]
    s = batch["tokens"].shape[1]
    return s + cfg.n_patches if cfg.frontend == "vision" else s


@contextlib.contextmanager
def local_params(module, plan, seq_len: int, grad: bool = False):
    """``module``'s parameters (DTensors laid out by ``mesh.param_specs``)
    replaced by their storage shards (the local tensors, split over
    "data" / "pod" and "model") as plain tensors, gradients on where
    ``grad``, and the tensor-parallel plan of ``plan`` in use for a
    stream of ``seq_len`` positions (none where "model" has one rank);
    code reads a leaf inside :func:`gathered`, which gathers its "data"
    dims.  Yields (``{name: storage shard}``, the state)."""
    from torch.distributed.tensor import Shard
    from torch.nn.utils.stateless import _reparametrize_module

    from . import mesh as mesh_lib
    m = plan.model_size
    names = plan.mesh.mesh_dim_names
    axes = [i for i, a in enumerate(names)
            if a != "model" and plan.mesh.size(i) > 1]
    local, dims, shards = {}, {}, {}
    for k, p in module.named_parameters():
        t = p.to_local().detach().requires_grad_(grad)
        local[k] = t
        dims[id(t)] = mesh_lib.model_dim(p)
        shards[id(t)] = tuple(p.placements[i].dim if isinstance(
            p.placements[i], Shard) else None for i in axes)
    global _STORE
    state = TPState(
        plan.mesh.get_group("model"), m, plan.mesh.get_local_rank("model"),
        seq_len % m == 0, dims,
        storage=tuple((plan.mesh.get_group(i), plan.mesh.size(i))
                      for i in axes), shards=shards)
    prev, _STORE = _STORE, state if axes else None
    # a "model" axis of one splits nothing: the mesh-less code on the
    # local leaves (gathered over "data" where it has more than one rank)
    try:
        with _reparametrize_module(module, local), \
                _use(state if m > 1 else None):
            yield local, state
    finally:
        _STORE = prev


def _leaves(module, names) -> dict:
    """``{dotted name: leaf in use}`` of ``module``'s parameters: every one
    where ``names`` is empty, else those of each named attribute (a
    parameter, or a submodule's every parameter; None skipped)."""
    if not names:
        return dict(module.named_parameters())
    out = {}
    for n in names:
        v = getattr(module, n)
        if isinstance(v, torch.nn.Module):
            out.update({f"{n}.{k}": t for k, t in v.named_parameters()})
        elif v is not None:
            out[n] = v
    return out


@contextlib.contextmanager
def gathered(module, *names):
    """Inside the block ``module``'s parameters (or the named attributes'
    alone: :func:`_leaves`) are their "model" shards, each storage shard
    gathered over the mesh axes other than "model" (one all-gather a leaf
    split over one; in backward its gradient reduce-scattered back, a
    leaf whole over the axis all-reduced), and registered for
    :func:`split` and :func:`whole`.  Each call gathers again: a layer
    recomputed under remat gathers inside its recomputation, and nothing
    gathered is held past the block but what autograd saves.  Nothing
    moves where no axis but "model" has more than one rank."""
    st = _STORE
    if st is None:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module
    swap, made = {}, []
    for k, t in _leaves(module, names).items():
        spec = st.shards.get(id(t))
        if spec is None:
            raise RuntimeError(f"{k} {tuple(t.shape)} is no storage shard "
                               f"of the parameters in use: gathered twice?")
        g = _GatherStorage.apply(t, tuple(zip(st.storage, spec)))
        if t.requires_grad:
            st.reduced.add(id(t))
        st.dims[id(g)] = st.dims[id(t)]
        swap[k] = g
        made.append(id(g))
    try:
        with _reparametrize_module(module, swap):
            yield
    finally:
        for i in made:
            st.dims.pop(i, None)


def reduced(t) -> bool:
    """Whether the storage shard ``t``'s gradient comes back summed over
    the axes other than "model": it went through :func:`gathered`, or no
    such axis has more than one rank."""
    return _STORE is None or id(t) in _STORE.reduced


# ---------------------------------------------------------------------------
# Collectives (c10d, on the "model" group and the storage axes)
# ---------------------------------------------------------------------------

def on_group(fn, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(x)`` for a collective of ``group``: a CUDA tensor crosses a
    gloo group as a host copy."""
    import torch.distributed as dist
    host = x.device.type == "cuda" \
        and dist.get_backend(group) == dist.Backend.GLOO
    out = fn(x.cpu() if host else x.contiguous())
    return out.to(x.device) if host else out


def _gather_on(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather of ``x`` along ``dim`` over the ``n`` ranks of
    ``group``."""
    import torch.distributed as dist

    def fn(t):
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        # contiguous: every product of the gathered sequence would copy it
        return out.movedim(0, dim).contiguous()
    return on_group(fn, x, group)


def _scatter_on(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``group``, this rank's slice of
    ``dim``, summed in float32 and returned in ``x``'s dtype."""
    import torch.distributed as dist

    def fn(t):
        t = t.float().movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim)
    return on_group(fn, x, group).to(x.dtype)


def _sum_on(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The elementwise sum (or ``op``) over ``group``, in float32,
    returned in ``x``'s dtype."""
    import torch.distributed as dist

    def fn(t):
        t = t.float().clone()
        dist.all_reduce(t, op or dist.ReduceOp.SUM, group=group)
        return t
    return on_group(fn, x, group).to(x.dtype)


class _GatherStorage(torch.autograd.Function):
    """A storage shard -> its "model" shard: gathered along its dim over
    each axis that splits it (the inner axis first); in backward the
    gradient reduce-scattered back over each (the outer first), then
    all-reduced over each axis that leaves the leaf whole (on the
    scattered shard: the sums commute).  ``axes`` holds ((group, size),
    dim or None) a storage axis, in mesh order."""
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        for (group, n), dim in reversed(axes):
            if dim is not None:
                x = _gather_on(x, dim, group, n)
        return x if any(d is not None for _, d in axes) else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for (group, n), dim in ctx.axes:
            if dim is not None:
                g = _scatter_on(g, dim, group, n)
        for (group, _), dim in ctx.axes:
            if dim is None:
                g = _sum_on(g, group)
        return g, None


def _slice(x: torch.Tensor, dim: int, st: TPState) -> torch.Tensor:
    n = x.shape[dim] // st.m
    return x.narrow(dim, st.j * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, st):
        ctx.st = st
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_on(g, ctx.st.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, st, dtype):
        ctx.dtype = x.dtype
        return _sum_on(x, st.group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; in backward reduce-scatter (the ranks'
    cotangents differ) or take this rank's slice (they are equal)."""
    @staticmethod
    def forward(ctx, x, dim, reduce_grad, st):
        ctx.dim, ctx.reduce_grad, ctx.st = dim, reduce_grad, st
        return _gather_on(x, dim, st.group, st.m)

    @staticmethod
    def backward(ctx, g):
        st = ctx.st
        if ctx.reduce_grad:
            return _scatter_on(g, ctx.dim, st.group, st.m), None, None, None
        return _slice(g, ctx.dim, st), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, st):
        ctx.dim, ctx.st = dim, st
        return _slice(x, dim, st)

    @staticmethod
    def backward(ctx, g):
        return _gather_on(g, ctx.dim, ctx.st.group, ctx.st.m), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, st, dtype):
        ctx.dim, ctx.st, ctx.dtype = dim, st, x.dtype
        return _scatter_on(x, dim, st.group, st.m).to(dtype)

    @staticmethod
    def backward(ctx, g):
        g = _gather_on(g, ctx.dim, ctx.st.group, ctx.st.m)
        return g.to(ctx.dtype), None, None, None


class _Sum(torch.autograd.Function):
    """All-reduce in forward and in backward: a sum of the ranks' partial
    values that each rank then uses on its own columns."""
    @staticmethod
    def forward(ctx, x, st):
        ctx.st = st
        return _sum_on(x, st.group)

    @staticmethod
    def backward(ctx, g):
        return _sum_on(g, ctx.st.group), None


def max_over_model(x):
    """The elementwise maximum over "model" (no gradient)."""
    import torch.distributed as dist
    return _sum_on(x.detach(), _STATE.group, dist.ReduceOp.MAX)


def sum_over_model(x):
    """The elementwise sum over "model" of the ranks' partial values (a
    norm's sum of squares over columns split across the ranks); in
    backward the cotangents summed too, each rank having used the sum on
    its own columns."""
    return _Sum.apply(x, _STATE)


def softmax_combine(scores, weigh):
    """A softmax over a sequence split over "model", applied to values:
    ``scores`` (..., s) are this rank's slice of the positions (masked
    slots at ``NEG_INF`` or -inf) and ``weigh(p)`` maps their weights p
    (..., s) to this rank's weighted values (..., dv).  Returns
    ``softmax(all scores) @ all values`` (..., dv) in float32, from one
    max and one sum over "model": the ranks' maxima meet first, so every
    rank exponentiates against the same finite maximum and a rank whose
    slice is all masked contributes exact zeros (its own maximum may be
    -inf, and exp(-inf - -inf) would be NaN)."""
    mx = max_over_model(scores.float().amax(-1, keepdim=True))
    p = torch.exp(scores.float() - mx)
    both = _sum_on(torch.cat([weigh(p), p.sum(-1, keepdim=True)], -1),
                   _STATE.group)
    return both[..., :-1] / both[..., -1:]


def copy_to_model(x):
    """Identity; in backward the cotangent all-reduced over "model"."""
    return _Copy.apply(x, _STATE)


def reduce_from_model(x, dtype=None):
    """All-reduce over "model" (summed in float32, returned in ``dtype``,
    default ``x``'s); identity in backward."""
    return _Reduce.apply(x, _STATE, dtype or x.dtype)


def gather_seq(x, reduce_grad: bool = True):
    """(B, S/m, ...) -> (B, S, ...), all-gathered over "model"; in
    backward reduce-scattered (``reduce_grad``) or sliced."""
    return _Gather.apply(x, 1, reduce_grad, _STATE)


def scatter_seq(x):
    """(B, S, ...) -> this rank's (B, S/m, ...); in backward
    all-gathered."""
    return _Split.apply(x, 1, _STATE)


def reduce_scatter_seq(x, dtype=None):
    """Partial sums (B, S, ...) -> their sum's (B, S/m, ...) slice (summed
    in float32, returned in ``dtype``, default ``x``'s); in backward
    all-gathered."""
    return _ReduceScatter.apply(x, 1, _STATE, dtype or x.dtype)


def gather_model(w, dim: int, reduce_grad: bool):
    """The ranks' pieces along ``dim`` -> the whole (all-gather over
    "model"): a leaf's shard, or a tensor of every rank's heads or
    columns; in backward reduce-scattered (``reduce_grad``: each rank's
    use differs) or sliced (every rank's use is the same)."""
    return _Gather.apply(w, dim, reduce_grad, _STATE)


def columns(x, *ws):
    """``x @ w`` (bf16 operands, bf16 out) for each leaf in ``ws`` with
    all its columns, for the decode step (no gradient): a leaf split over
    "model" along its columns is multiplied on this rank's columns and
    the products' columns are all-gathered, one gather for all of them
    (an activation: a token's is B x sum(d_out) / m); a whole leaf is
    multiplied whole."""
    from ..nn.layers import matmul
    out = [None] * len(ws)
    mine = [i for i, w in enumerate(ws) if split(w, 1)]
    for i, w in enumerate(ws):
        if i not in mine:
            out[i] = matmul(x, whole(w, False))
    if mine:
        widths = [ws[i].shape[1] for i in mine]
        local = torch.cat([matmul(x, ws[i]) for i in mine], -1)
        got = gather_model(local, local.ndim - 1, True)
        got = got.reshape(got.shape[:-1] + (_STATE.m, sum(widths)))
        for i, part in zip(mine, got.split(widths, -1)):
            out[i] = part.reshape(part.shape[:-2] + (-1,))
    return out


def block(t, dim: int, n: int):
    """This rank's block of ``n`` along ``dim`` of the leaf ``t`` (block j
    of the "model" rank j): the leaf itself where it is that shard, else
    cut from the whole leaf (gathered, or the replicated leaf with its
    gradient all-reduced)."""
    if split(t, dim) and t.shape[dim] == n:
        return t
    return whole(t, True).narrow(dim, _STATE.j * n, n)


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------

def enter(x):
    """Into a tensor-parallel layer: the stream slice -> the whole
    sequence (its cotangents summed over the ranks' columns)."""
    return gather_seq(x) if _STATE.sp else copy_to_model(x)


def leave(partial, dtype):
    """Out of a tensor-parallel layer: float32 partial sums -> the
    stream's slice of their sum, rounded once to ``dtype`` (its
    cotangents move in ``dtype``)."""
    return reduce_scatter_seq(partial, dtype) if _STATE.sp \
        else reduce_from_model(partial, dtype)


def enter_whole(x):
    """Into a layer every rank runs whole: the whole sequence, the same
    on every rank (as are its cotangents)."""
    return gather_seq(x, reduce_grad=False) if _STATE.sp else x


def leave_whole(y):
    """Out of a whole layer: the stream's slice of its output."""
    return scatter_seq(y) if _STATE.sp else y


def sliced() -> bool:
    """Whether a plan is in use and the stream is a sequence slice."""
    return _STATE is not None and _STATE.sp


def on_shard(p):
    """A replicated parameter used on the sequence slice: its gradient
    all-reduced over "model" in backward (a LayerNorm's ``g`` and ``b``
    alike); itself where no plan is in use or the stream is whole."""
    if not sliced():
        return p
    if isinstance(p, torch.Tensor):
        return copy_to_model(p)
    return types.SimpleNamespace(g=copy_to_model(p.g), b=copy_to_model(p.b))


def split(t, dim: int) -> bool:
    """Whether the leaf ``t`` in use is a "model" shard along ``dim``."""
    return _STATE is not None and t is not None \
        and _STATE.dims.get(id(t)) == dim % t.ndim


def whole(t, reduce_grad: bool, dtype=None):
    """The whole leaf of a local one: gathered over "model" where it is a
    shard (:func:`gather_model`); a replicated leaf itself, its gradient
    all-reduced where ``reduce_grad`` (each rank's use differs).  With
    ``dtype`` the leaf is cast first (a weight that only feeds bf16
    products moves in bf16).  ``t`` itself where no plan is in use."""
    if _STATE is None or t is None:
        return t
    dim = _STATE.dims.get(id(t))
    if dtype is not None:
        t = t.to(dtype)
    if dim is None:
        return copy_to_model(t) if reduce_grad else t
    return gather_model(t, dim, reduce_grad)
