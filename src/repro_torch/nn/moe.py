"""Mixture-of-Experts FFN with capacity-based dispatch.

Port of ``repro/nn/moe.py`` (``set_dispatch_mode``, ``moe_init``,
``set_moe_impl``, ``moe_ffn``, ``_expert_compute``, ``_local_dispatch``,
``_moe_ffn_shardmap``, ``_moe_ffn_dense``).  Experts are stacked on a
leading E axis, float32 ``(E, d_in, d_out)``; a call routes each token to its top-k experts
(softmax over the float32 router logits, the k gates renormalised),
places each (token, choice) at its rank among the expert's slots in token
order, drops what lies past the expert's capacity, scatters the kept
tokens into a zero ``(E, C, d)`` bf16 buffer, runs the expert FFNs as
batched bf16 products, gathers each choice's row back and combines the k
rows in float32 by their gates.  The products are plain batched matmuls,
as in the reference (``jnp.einsum`` there, outside any Pallas kernel).

Capacity is computed over the call's token count, as in the reference:
prefill (per batch) and decode (per step) drop differently; a decode step
of 4 tokens with 16 experts and top-2 keeps one slot an expert.

``set_moe_impl("shardmap")`` is expert parallelism with an explicit
all-to-all, used where a ``launch.mesh.Plan`` is active
(``launch.context.use_plan``; the dense dispatch otherwise, as in the
reference): each rank holds its data shard's tokens, splits them over the
mesh's "model" axis, routes its own into per-expert send buffers, one
``all_to_all_single`` over the "model" group carries them to the experts'
owners (rank j of the axis owns experts j·E/m ...), the owners run their
experts, the reverse all-to-all and a local gather combine, and an
all-gather over "model" gives every rank its whole shard's output.  No
(E, C, d) buffer of all the tokens exists anywhere.  Both exchanges are
differentiable (``torch.distributed._functional_collectives``' autograd
forms); CUDA tensors cross a gloo group through host copies.  Under a
tensor-parallel plan (``launch.tensor_parallel``) the experts are the
rank's own "model" shard of the stacks.  Where the stream is the
sequence's slice, "shardmap" routes it without slicing again and returns
the slice.  The dense dispatch, and "shardmap" where the stream is whole
(a decode token), run expert-parallel: every rank routes the tokens
``enter`` gives it (the whole sequence of its data shard, or the decode
token: the mesh-less call's tokens, so capacity, routing and drops are
the same), scatters only into its E/m experts' buffers, runs them, and
its gate-weighted rows, summed in float32, leave the layer as partial
sums over "model".
:func:`record_routing` collects each call's routing, for comparing two
runs' decisions; :func:`replay_routing` makes a run take another run's
expert choices (top-k routing is discontinuous: an ulp of a hidden state
can flip a choice, so two numerically different paths are compared on
the same choices).
"""
from __future__ import annotations

import contextlib
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, act_fn, dense_init, mlp,
                     mlp_init, param)

__all__ = ["MoE", "moe_init", "set_dispatch_mode", "set_moe_impl", "moe_ffn",
           "record_routing", "replay_routing", "routing_hooked"]

# Dispatch position computation:
#  "cumsum": one-hot cumsum, an O(T·K·E) int intermediate
#  "sort":   argsort + searchsorted rank-in-expert, O(T·K) memory
_DISPATCH_MODE = "sort"
# "dense": single-program scatter/gather dispatch
# "shardmap": explicit token split + all-to-all expert exchange on a mesh
_MOE_IMPL = "dense"
_ROUTING: list | None = None
_REPLAY: tuple | None = None


def set_dispatch_mode(mode: str) -> None:
    global _DISPATCH_MODE
    if mode not in ("sort", "cumsum"):
        raise ValueError(f"dispatch mode {mode!r}: 'sort' or 'cumsum'")
    _DISPATCH_MODE = mode


def set_moe_impl(impl: str) -> None:
    global _MOE_IMPL
    if impl not in ("dense", "shardmap"):
        raise ValueError(f"MoE impl {impl!r}: 'dense' or 'shardmap'")
    _MOE_IMPL = impl


@contextlib.contextmanager
def record_routing():
    """Inside the block every ``moe_ffn`` call appends its routing, in
    call order: ``(expert id, position in the expert, keep)``, each of
    shape (T * top_k,) in (token, choice) order, and the router
    probabilities (T, E) in float32 they came from."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


@contextlib.contextmanager
def replay_routing(choices: list):
    """Inside the block every ``moe_ffn`` call takes its experts from the
    front of ``choices`` (each entry the expert ids of one call, (T * top_k)
    or (T, top_k) in (token, choice) order, as :func:`record_routing`
    gives them; consumed in call order) in place of its router's top-k;
    the gates are its own router probabilities of those experts,
    renormalised.  Yields a list that gets, a call, the number of tokens
    whose own top-k differs."""
    global _REPLAY
    prev, changed = _REPLAY, []
    _REPLAY = (choices, changed)
    try:
        yield changed
    finally:
        _REPLAY = prev


def routing_hooked() -> bool:
    """Whether :func:`record_routing` or :func:`replay_routing` is active
    (remat does not recompute a layer then: a recomputation would record
    or consume its calls twice)."""
    return _ROUTING is not None or _REPLAY is not None


def _stack(gen, n: int, d_in: int, d_out: int, device) -> torch.Tensor:
    shape = (n, d_in, d_out)
    if gen is None:
        return torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    return torch.randn(shape, generator=gen, dtype=PARAM_DTYPE,
                       device=device).div_(d_in ** 0.5)   # in place


class MoE(nn.Module):
    """The reference's ``moe_init`` dict: ``router`` (d, E), the stacked
    expert weights ``w_up`` / ``w_gate`` (E, d, d_ff) and ``w_down``
    (E, d_ff, d), drawn N(0, 1) / sqrt(d_in), and an optional ``shared``
    MLP applied to every token."""

    def __init__(self, d: int, d_ff: int, n_experts: int, gated: bool,
                 n_shared: int = 0, shared_d_ff: int = 0, device=None,
                 gen=None):
        super().__init__()
        self.router = param(dense_init(gen, d, n_experts, device))
        self.w_up = param(_stack(gen, n_experts, d, d_ff, device))
        self.w_down = param(_stack(gen, n_experts, d_ff, d, device))
        self.w_gate = param(_stack(gen, n_experts, d, d_ff, device)) \
            if gated else None
        self.shared = mlp_init(gen, d, shared_d_ff or d_ff * n_shared, gated,
                               device) if n_shared else None


def moe_init(gen, d: int, d_ff: int, n_experts: int, gated: bool,
             n_shared: int = 0, shared_d_ff: int = 0, device=None) -> MoE:
    return MoE(d, d_ff, n_experts, gated, n_shared, shared_d_ff, device, gen)


def _gates(xt: torch.Tensor, router: torch.Tensor, top_k: int,
           logits: torch.Tensor | None = None):
    """The float32 router softmax (T, E), its top-k experts (T, K) and
    their gates renormalised (T, K); ``logits`` (T, E), where given, are
    the float32 router logits ``xt @ router`` already computed."""
    if logits is None:
        logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    if _REPLAY is None:
        gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    else:
        choices, changed = _REPLAY
        gate_idx = torch.as_tensor(choices.pop(0), device=probs.device) \
            .reshape(-1, top_k).long()
        own = torch.topk(probs, top_k, dim=-1).indices
        changed.append(int((own != gate_idx).any(-1).sum()))
        gate_vals = probs.gather(-1, gate_idx)
    return probs, gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9), \
        gate_idx


def _positions(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each slot among the slots of its expert, in slot order."""
    n = flat_e.shape[0]
    if _DISPATCH_MODE == "sort":
        # stable-sort slots by expert id; rank within expert = sorted index
        # - first index of that expert; scatter ranks back to slot order
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.zeros(n, dtype=torch.int64, device=flat_e.device)
        pos[order] = torch.arange(n, device=flat_e.device) - first
        return pos
    onehot = F.one_hot(flat_e, n_experts)                          # (T*K, E)
    return ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)


def _local_dispatch(xt: torch.Tensor, router, top_k: int, capacity: int,
                    own: tuple | None = None, logits=None):
    """Routing and scatter: (buf (E, C, d) bf16, expert id, slot (the
    position, or C - 1 where dropped), keep, gates (T, K)), the ids, slots
    and keep of shape (T * K,).  With ``own`` (first, count) only those
    experts' rows of the buffer exist (count, C, d): the ids are relative
    to ``first`` and the other experts' slots are not kept; ``logits`` as
    :func:`_gates`'s."""
    t, d = xt.shape
    probs, gate_vals, gate_idx = _gates(xt, router, top_k, logits)
    e = probs.shape[-1]
    flat_e = gate_idx.reshape(-1)
    pos = _positions(flat_e, e)
    keep = pos < capacity                                          # drops
    if _ROUTING is not None:
        _ROUTING.append((flat_e, pos, keep, probs))
    if own is not None:
        first, e = own
        flat_e = flat_e - first
        keep = keep & (flat_e >= 0) & (flat_e < e)
        flat_e = flat_e.clamp(0, e - 1)
    idx_c = torch.where(keep, pos, capacity - 1)
    src = xt.to(COMPUTE_DTYPE).repeat_interleave(top_k, dim=0)
    src = torch.where(keep[:, None], src, 0)
    buf = torch.zeros((e, capacity, d), dtype=COMPUTE_DTYPE, device=xt.device)
    buf.index_put_((flat_e, idx_c), src, accumulate=True)
    return buf, flat_e, idx_c, keep, gate_vals


def _expert_compute(p: MoE, buf: torch.Tensor, act: str,
                    gated: bool) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d) through the expert FFNs, bf16 products
    (each call casts the float32 experts, as the reference's astype)."""
    up = torch.bmm(buf, p.w_up.to(COMPUTE_DTYPE))
    if gated:
        g = torch.bmm(buf, p.w_gate.to(COMPUTE_DTYPE))
        h = act_fn(act)(g.float()).to(COMPUTE_DTYPE) * up
    else:
        h = act_fn(act)(up.float()).to(COMPUTE_DTYPE)
    return torch.bmm(h, p.w_down.to(COMPUTE_DTYPE))


def _combine(out_e, idx_e, idx_c, keep, gate_vals, t: int, top_k: int):
    """Each (token, choice)'s expert row gathered back (zero where not
    kept), weighted by its gate and summed over the k choices in
    float32: (T, d)."""
    gathered = torch.where(keep[:, None], out_e[idx_e, idx_c], 0)
    weighted = gathered.float() * gate_vals.reshape(-1, 1).float()
    return weighted.reshape(t, top_k, -1).sum(dim=1)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over ``group`` along dim 0 (equal
    splits); the identity on a group of one."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc

    from ..launch.tensor_parallel import on_group
    if dist.get_world_size(group) == 1:
        return x
    return on_group(lambda t: fc.wait_tensor(fc.all_to_all_single_autograd(
        t, None, None, group)), x, group)


def _gather_seq(y: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of (b, s_loc, d) pieces along dim 1."""
    from torch.distributed import _functional_collectives as fc

    from ..launch.tensor_parallel import on_group
    return on_group(lambda t: fc.wait_tensor(fc.all_gather_tensor_autograd(
        t, 1, group)), y, group)


def _expert_parallel(router, own, xl: torch.Tensor, *, top_k: int, act: str,
                     gated: bool, capacity_factor: float, group, m: int):
    """This rank's tokens ``xl`` (b, s, d) through the experts of every
    rank of ``group`` (m ranks, E / m experts each; ``own`` holds this
    rank's stacks): routing, the all-to-all there and back, the combine."""
    bl, sl, d = xl.shape
    e = router.shape[-1]
    e_loc = e // m
    capacity = max(1, int(capacity_factor * bl * sl * top_k / e))
    buf, flat_e, idx_c, keep, gate_vals = _local_dispatch(
        xl.reshape(bl * sl, d), router, top_k, capacity)
    # send: peer i gets experts i·e_loc ...; the owner sees (peer, e_loc,
    # C, d), its experts' C slots of every peer side by side
    recv = _exchange(buf, group).reshape(m, e_loc, capacity, d) \
        .transpose(0, 1).reshape(e_loc, m * capacity, d)
    out = _expert_compute(own, recv, act, gated)
    back = _exchange(out.reshape(e_loc, m, capacity, d).transpose(0, 1)
                     .reshape(e, capacity, d), group)    # (E, C, d) own view
    out = _combine(back, flat_e, idx_c, keep, gate_vals, bl * sl, top_k)
    return out.to(COMPUTE_DTYPE).reshape(bl, sl, d)


def _moe_ffn_shardmap(p: MoE, x: torch.Tensor, *, top_k: int, act: str,
                      gated: bool, capacity_factor: float, plan):
    """Expert parallelism over the plan's "model" axis; ``x`` (b, s, d) is
    this rank's data shard (every rank of a "model" row holds the same
    one) and ``p`` the whole layer."""
    b, s, d = x.shape
    e = p.router.shape[-1]
    group = plan.mesh.get_group("model")
    m = plan.model_size
    if e % m:
        raise ValueError(f"{e} experts do not split over {m} model ranks")
    e_loc = e // m
    j = plan.mesh.get_local_rank("model")
    split = s % m == 0 and s >= m      # else every model rank routes all
    xl = x[:, j * (s // m):(j + 1) * (s // m)] if split else x
    mine = slice(j * e_loc, (j + 1) * e_loc)
    own = types.SimpleNamespace(
        w_up=p.w_up[mine], w_down=p.w_down[mine],
        w_gate=p.w_gate[mine] if gated else None)
    y = _expert_parallel(p.router, own, xl, top_k=top_k, act=act,
                         gated=gated, capacity_factor=capacity_factor,
                         group=group, m=m)
    return _gather_seq(y, group) if split and m > 1 else y


def _moe_ffn_dense(p: MoE, x: torch.Tensor, *, top_k: int, act: str,
                   gated: bool, capacity_factor: float = 1.25):
    b, s, d = x.shape
    e = p.router.shape[-1]
    t = b * s
    capacity = max(1, int(capacity_factor * t * top_k / e))
    buf, idx_e, idx_c, keep, gate_vals = _local_dispatch(
        x.reshape(t, d), p.router, top_k, capacity)
    out_e = _expert_compute(p, buf, act, gated)
    out = _combine(out_e, idx_e, idx_c, keep, gate_vals, t, top_k)
    y = out.reshape(b, s, d).to(COMPUTE_DTYPE)
    if p.shared is not None:
        y = y + mlp(p.shared, x, act, gated)
    return y


def _expert_parallel_dense(p: MoE, x: torch.Tensor, tp, *, top_k: int,
                           act: str, gated: bool, capacity_factor: float):
    """The dense dispatch over "model": this rank's E/m experts on the
    tokens ``enter`` gives it, routed with the mesh-less call's capacity
    by the whole router (gathered, its gradient reduce-scattered back;
    where the tokens are fewer than d, as a decode step's, their router
    logits are gathered instead: T x E, not d x E); the float32 sum of
    its experts' gate-weighted rows leaves the layer."""
    st = tp.current()
    xf = tp.enter(x)
    b, s, d = xf.shape
    t, e_loc = b * s, p.w_up.shape[0]
    xt = xf.reshape(t, d)
    router, logits = p.router, None
    if tp.split(router, 1) and t < d:    # T x E logits, smaller than d x E
        logits = tp.gather_model(xt.float() @ router.float(), 1, True)
    else:
        router = tp.whole(router, True)
    e = st.m * e_loc
    capacity = max(1, int(capacity_factor * t * top_k / e))
    buf, idx_e, idx_c, keep, gate_vals = _local_dispatch(
        xt, router, top_k, capacity, (st.j * e_loc, e_loc), logits)
    out_e = _expert_compute(p, buf, act, gated)
    part = _combine(out_e, idx_e, idx_c, keep, gate_vals, t, top_k)
    return tp.leave(part.reshape(b, s, d), COMPUTE_DTYPE)


def _moe_ffn_tp(p: MoE, x: torch.Tensor, tp, **run) -> torch.Tensor:
    """Under a tensor-parallel plan: "shardmap" on a sequence-sliced
    stream routes the slice as it is to the local experts' owners (the
    router gathered, its gradient reduce-scattered back) and returns the
    slice; the dense dispatch, and "shardmap" on a whole stream (decode),
    run expert-parallel (:func:`_expert_parallel_dense`).  Raises where
    the expert stacks do not split over "model"."""
    st = tp.current()
    gated = run["gated"]
    if not (tp.split(p.w_up, 0) and tp.split(p.w_down, 0)
            and (not gated or tp.split(p.w_gate, 0))):
        raise ValueError(f"{p.w_up.shape[0]} experts do not split over "
                         f"{st.m} model ranks")
    if _MOE_IMPL == "shardmap" and st.sp:
        y = _expert_parallel(tp.whole(p.router, True), p, x, group=st.group,
                             m=st.m, **run)
    else:
        y = _expert_parallel_dense(p, x, tp, **run)
    if p.shared is not None:
        y = y + mlp(p.shared, x, run["act"], gated)
    return y


def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int, act: str, gated: bool,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) bf16.  Top-k routing with per-expert
    capacity ``max(1, int(capacity_factor * T * top_k / E))`` over the
    call's T tokens (a rank's own under "shardmap")."""
    from ..launch import tensor_parallel as tp
    from ..launch.context import current_plan
    if tp.current() is not None:
        return _moe_ffn_tp(p, x, tp, top_k=top_k, act=act, gated=gated,
                           capacity_factor=capacity_factor)
    plan = current_plan()
    if _MOE_IMPL == "shardmap" and plan is not None:
        y = _moe_ffn_shardmap(p, x, top_k=top_k, act=act, gated=gated,
                              capacity_factor=capacity_factor, plan=plan)
        if p.shared is not None:
            y = y + mlp(p.shared, x, act, gated)
        return y
    return _moe_ffn_dense(p, x, top_k=top_k, act=act, gated=gated,
                          capacity_factor=capacity_factor)
