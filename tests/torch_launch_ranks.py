"""Rank tasks of the launcher parity tests (test_torch_compress.py,
test_torch_moe_shardmap.py, test_torch_elastic.py,
test_torch_tensor_parallel.py).

A :class:`~repro_torch.core.party_group.PartyGroup` rank unpickles the
task functions it runs by module, so they live here, in a module that
imports ``repro_torch`` and torch only (no rank imports JAX).  Each task
is ``fn(state, *args)`` over the group's gloo ranks and returns CPU
tensors and plain values.
"""
import contextlib
import json

import torch

from repro_torch.launch import mesh as mesh_lib


def _mesh(state, shape, axes):
    """One ``DeviceMesh`` a (shape, axes) per rank process (making one
    makes process groups, a collective every rank joins)."""
    meshes = state.setdefault("meshes", {})
    key = (tuple(shape), tuple(axes))
    if key not in meshes:
        meshes[key] = mesh_lib.make_mesh(shape, axes, "cpu")
    return meshes[key]


def compress(state, g):
    """``int8_psum`` of this rank's pod slice of ``g`` (P, ...) over the
    "pod" axis of a (P, world / P) ("pod", "data") mesh."""
    from repro_torch.optim.compress import compressed_tree_psum, int8_psum
    pods = g.shape[0]
    mesh = _mesh(state, (pods, state["world"] // pods), ("pod", "data"))
    grp = mesh.get_group("pod")
    mine = g[mesh.get_local_rank("pod")]
    tree = compressed_tree_psum({"a": mine, "b": None, "c": mine[0]}, grp)
    return int8_psum(mine, grp), tree


def moe_shardmap(state, shape, sd, x, capacity_factor):
    """Each rank's output of the "shardmap" MoE on its data shard of ``x``
    under a (data, model) mesh of ``shape``, and the gradient of its
    output's sum with respect to every expert parameter."""
    from repro_torch.launch.context import use_plan
    from repro_torch.nn import moe
    mesh = _mesh(state, shape, ("data", "model"))
    plan = mesh_lib.Plan(mesh)
    d = sd["router"].shape[0]
    p = moe.MoE(d, sd["w_up"].shape[-1], sd["router"].shape[1], True,
                device="cpu")
    p.load_state_dict(sd)
    b = x.shape[0] // shape[0]
    xl = x[mesh.get_local_rank("data") * b:][:b].bfloat16()
    run = dict(top_k=2, act="silu", gated=True,
               capacity_factor=capacity_factor)
    moe.set_moe_impl("shardmap")
    try:
        with use_plan(plan):
            y = moe.moe_ffn(p, xl, **run)
            ps = [p.router, p.w_up, p.w_gate, p.w_down]
            for t in ps:
                t.requires_grad_(True)
            out = moe.moe_ffn(p, xl, **run).float().sum()
            grads = torch.autograd.grad(out, ps)
    finally:
        moe.set_moe_impl("dense")
    return y.float(), [g.detach() for g in grads]


def train(state, cfg, tcfg, shape, opt_cfg=None):
    """``Trainer(mesh=...)`` on a ("data", "model") mesh of ``shape``:
    (whole parameters, their placements and local shapes, embed's
    moment's placements, metrics) on rank 0."""
    from repro_torch.train import Trainer
    mesh = _mesh(state, shape, ("data", "model"))
    tr = Trainer(cfg, tcfg, opt_cfg, mesh=mesh)
    params, opt, metrics = tr.run(resume=True)
    whole = {k: mesh_lib.full(p).clone()
             for k, p in params.named_parameters()}
    place = {k: (str(p.placements), tuple(p.to_local().shape))
             for k, p in params.named_parameters()}
    m = opt["m"]["embed"]
    m_place = {k: str(v.placements) for k, v in m.items()} \
        if isinstance(m, dict) else str(m.placements)
    return whole, place, m_place, metrics


def restore_onto(state, ckpt_dir, cfg, shape):
    """``restore_checkpoint(..., shardings=)`` of the parameters onto a
    ("data", "model") mesh of ``shape``, in the reference's layout (a
    stacked layer leaf takes its layers' spec behind a replicated layer
    axis): each restored leaf whole, its placements, and the step."""
    from repro_torch.nn.transformer import abstract_params, layer_groups
    from repro_torch.train import restore_checkpoint
    from repro_torch.weights import lm_tree
    mesh = _mesh(state, shape, ("data", "model"))
    plan = mesh_lib.Plan(mesh)
    model = abstract_params(cfg)
    named = {k: torch.zeros(p.shape, dtype=p.dtype)
             for k, p in model.named_parameters()}
    template = lm_tree(named, cfg)
    specs = mesh_lib.param_specs(model, plan)
    firsts, first = [], 0
    for g in layer_groups(cfg):
        firsts.append(first)
        first += g.count

    def sh(tree, path):
        if isinstance(tree, dict):
            return {k: sh(v, path + [k]) for k, v in tree.items()}
        if path[0].startswith("group"):
            j = firsts[int(path[0][5:])]
            spec = (None,) + specs[".".join(["layers", str(j)] + path[1:])]
        else:
            spec = specs[".".join(path)]
        return (mesh, plan.placements(spec))

    st, step, _ = restore_checkpoint(ckpt_dir, {"params": template},
                                     shardings={"params": sh(template, [])})

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + [k])
        else:
            yield ".".join(path), tree
    leaves = dict(walk(st["params"], []))
    return ({k: v.full_tensor() for k, v in leaves.items()},
            {k: (str(v.placements), tuple(v.to_local().shape))
             for k, v in leaves.items()}, step)


@contextlib.contextmanager
def widths():
    """The widths a rank computes inside the block: the q and kv heads of
    each GQA call, MLA's heads (its float32 ``_sdpa``: q wider than v),
    the FFN columns of each MLP, Mamba-2's heads (the scan's, or the
    decode state's) and gate columns (the gated norm's), the experts a
    MoE call runs and the logits' columns."""
    from repro_torch.nn import attention, layers, moe, ssm, transformer
    seen = {k: set() for k in ("q_heads", "kv_heads", "mla_heads", "ffn",
                               "ssm_heads", "gate", "experts", "vocab")}
    saved = (attention._attend, attention._sdpa, layers._hidden,
             ssm.ssd_chunked, ssm._gated_norm, moe._expert_compute,
             transformer._logits)
    attend, sdpa, hidden, chunked, gated, experts, logits = saved

    def attend_w(q, k, *a):
        seen["q_heads"].add(q.shape[2])
        seen["kv_heads"].add(k.shape[2])
        return attend(q, k, *a)

    def sdpa_w(q, k, v, *a, **kw):
        if q.shape[-1] != v.shape[-1]:
            seen["mla_heads"].add(q.shape[2])
        return sdpa(q, k, v, *a, **kw)

    def hidden_w(*a):
        out = hidden(*a)
        seen["ffn"].add(out.shape[-1])
        return out

    def chunked_w(x, *a):
        seen["ssm_heads"].add(x.shape[2])
        return chunked(x, *a)

    def gated_w(y, *a, **kw):
        seen["gate"].add(y.shape[-1])
        return gated(y, *a, **kw)

    def experts_w(p, buf, *a):
        seen["experts"].add(buf.shape[0])
        return experts(p, buf, *a)

    def logits_w(*a):
        out = logits(*a)
        seen["vocab"].add(out.shape[-1])
        return out
    (attention._attend, attention._sdpa, layers._hidden, ssm.ssd_chunked,
     ssm._gated_norm, moe._expert_compute, transformer._logits) = (
        attend_w, sdpa_w, hidden_w, chunked_w, gated_w, experts_w, logits_w)
    try:
        yield seen
    finally:
        (attention._attend, attention._sdpa, layers._hidden,
         ssm.ssd_chunked, ssm._gated_norm, moe._expert_compute,
         transformer._logits) = saved


def _sharded_lm(cfg, sd, plan):
    from repro_torch.nn.transformer import LM
    model = LM(cfg, device="cpu")
    model.load_state_dict(sd)
    mesh_lib.shard_params(model, plan)
    return model


def tp_train(state, cfg, shape, sd, batches, opt_cfg):
    """``len(batches)`` tensor-parallel train steps of ``cfg`` from the
    weights ``sd`` on a ("data", "model") mesh of ``shape`` (each rank its
    data shard of every batch): (whole parameters, each step's (loss,
    gradient norm), the widths computed)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    plan = mesh_lib.Plan(_mesh(state, shape, ("data", "model")))
    model = _sharded_lm(cfg, sd, plan)
    opt = mesh_lib.conform_opt(adamw_init(dict(model.named_parameters()),
                                          opt_cfg), model, plan)
    step = make_train_step(cfg, opt_cfg, plan)
    metrics = []
    with widths() as seen:
        for b in batches:
            model, opt, m = step(model, opt, mesh_lib.local_batch(b, plan))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    whole = {k: mesh_lib.full(p).clone()
             for k, p in model.named_parameters()}
    return whole, metrics, {k: sorted(v) for k, v in seen.items()}


def tp_prefill(state, cfg, shape, sd, batch):
    """The tensor-parallel prefill step's last-position logits of this
    rank's data shard of ``batch`` (and the shard's first row), and the
    widths computed."""
    from repro_torch.launch.steps import make_prefill_step
    plan = mesh_lib.Plan(_mesh(state, shape, ("data", "model")))
    model = _sharded_lm(cfg, sd, plan)
    local = mesh_lib.local_batch(batch, plan)
    with widths() as seen:
        logits = make_prefill_step(cfg, None, plan)(model, local)
    first = plan.mesh.get_local_rank("data") * next(iter(local.values())).shape[0]
    return logits, first, {k: sorted(v) for k, v in seen.items()}


def tp_unsplit(state, cfg, shape, sd, batch):
    """The message of the error the tensor-parallel prefill step raises
    on a ("data", "model") mesh of ``shape``, or None where it runs."""
    from repro_torch.launch.steps import make_prefill_step
    plan = mesh_lib.Plan(_mesh(state, shape, ("data", "model")))
    model = _sharded_lm(cfg, sd, plan)
    try:
        make_prefill_step(cfg, None, plan)(model,
                                          mesh_lib.local_batch(batch, plan))
    except ValueError as e:
        return str(e)
    return None


def tp_decode(state, cfg, shape, sd, cache, steps, mla_absorbed=True,
              choices=None):
    """Tensor-parallel decode steps of ``cfg`` from the weights ``sd`` and
    the whole cache ``cache`` (one dict a layer, laid out on a ("data",
    "model") mesh of ``shape`` by ``cache_specs``), one step a (tokens,
    pos) of ``steps`` (each rank its data shard of the tokens): each
    step's logits, the data shard's first row, the rank's "model" index,
    its cache shards after the last step and the widths computed.  With
    ``choices`` (``moe.record_routing``'s expert ids of another run) the
    MoE layers take those experts (``moe.replay_routing``): "changed"
    counts, a call, the tokens whose own top-k differs."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.nn import moe
    plan = mesh_lib.Plan(_mesh(state, shape, ("data", "model")))
    model = _sharded_lm(cfg, sd, plan)
    specs = mesh_lib.cache_specs(cache, plan)

    def lay(tree, spec):
        return {k: lay(v, spec[k]) if isinstance(v, dict)
                else mesh_lib.shard(v.clone(), plan, spec[k])
                for k, v in tree.items()}

    def local(tree):
        return {k: local(v) if isinstance(v, dict) else v.to_local().clone()
                for k, v in tree.items()}
    dcache = [lay(c, s) for c, s in zip(cache, specs)]
    step = make_decode_step(cfg, mla_absorbed, plan)
    out = []
    replay = moe.replay_routing(list(choices)) if choices is not None \
        else contextlib.nullcontext([])
    with widths() as seen, replay as changed:
        for tokens, pos in steps:
            toks = mesh_lib.local_batch({"tokens": tokens}, plan)["tokens"]
            logits, dcache = step(model, dcache, {"tokens": toks,
                                                  "pos": pos})
            out.append(logits.float())
    return {"logits": out,
            "first": plan.mesh.get_local_rank("data") * toks.shape[0],
            "j": plan.mesh.get_local_rank("model"),
            "cache": [local(c) for c in dcache], "changed": changed,
            "widths": {k: sorted(v) for k, v in seen.items()}}


def tp_softmax(state, scores, values):
    """``tensor_parallel.softmax_combine`` of this rank's slice of the
    positions (``scores`` (..., S), ``values`` (S, dv), split over the
    ranks of a (1, world) mesh)."""
    from repro_torch.launch import tensor_parallel as tp
    plan = mesh_lib.Plan(_mesh(state, (1, state["world"]), ("data",
                                                            "model")))
    m, j = plan.model_size, plan.mesh.get_local_rank("model")
    n = scores.shape[-1] // m
    root = torch.nn.Module()
    with tp.local_params(root, plan, 1):
        return tp.softmax_combine(scores[..., j * n:(j + 1) * n],
                                  lambda p: p @ values[j * n:(j + 1) * n])


def tp_dims(state, cfg, sd):
    """Each parameter's "model" dim on a (1, 2) mesh as the tensor-parallel
    step reads it: ``mesh.model_dim`` of the DTensor and ``TPState.dims``
    of its local shard inside ``local_params``."""
    from repro_torch.launch import tensor_parallel as tp
    plan = mesh_lib.Plan(_mesh(state, (1, 2), ("data", "model")))
    model = _sharded_lm(cfg, sd, plan)
    dims = {k: mesh_lib.model_dim(p) for k, p in model.named_parameters()}
    with tp.local_params(model, plan, 8) as (local, st):
        used = {k: st.dims[id(v)] for k, v in local.items()}
    return dims, used


def tp_moe(state, sd, x):
    """A "shardmap" MoE layer (``sd``) on a (1, 2) mesh two ways: under
    tensor parallelism (the layer's "model" shards, this rank's sequence
    slice of ``x`` in, its slice out) and on the mesh route (the whole
    layer, the whole sequence, gathered out); each with the gradients of
    its output's sum over the rank's slice with respect to the router and
    the rank's own experts: [(y, grads)] for both."""
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.launch.context import use_plan
    from repro_torch.nn import moe
    plan = mesh_lib.Plan(_mesh(state, (1, 2), ("data", "model")))
    j, s = plan.mesh.get_local_rank("model"), x.shape[1] // 2
    own = slice(j * s, (j + 1) * s)
    root = torch.nn.Module()
    root.layers = torch.nn.ModuleList([torch.nn.Module()])
    layer = moe.MoE(16, 32, 8, True, device="cpu")
    layer.load_state_dict(sd)
    root.layers[0].ffn = layer
    xb = x.bfloat16()
    run = dict(top_k=2, act="silu", gated=True, capacity_factor=8.0)
    moe.set_moe_impl("shardmap")
    try:
        with use_plan(plan):
            ps = [layer.router, layer.w_up, layer.w_gate, layer.w_down]
            for t in ps:
                t.requires_grad_(True)
            y = moe.moe_ffn(layer, xb, **run)[:, own]
            g = torch.autograd.grad(y.float().sum(), ps)
            mesh_route = (y.detach().float(),
                          [g[0]] + [t[j * 4:(j + 1) * 4] for t in g[1:]])
            for t in ps:
                t.requires_grad_(False)
        mesh_lib.shard_params(root, plan)
        with tp.local_params(root, plan, x.shape[1], grad=True) as (lv, _):
            y = moe.moe_ffn(root.layers[0].ffn, xb[:, own], **run)
            g = torch.autograd.grad(y.float().sum(), [
                lv["layers.0.ffn." + k] for k in ("router", "w_up",
                                                   "w_gate", "w_down")])
            router = tp.gather_model(g[0], 1, False)
    finally:
        moe.set_moe_impl("dense")
    return (y.detach().float(), [router] + list(g[1:])), mesh_route


def _calls():
    """A dispatch mode recording each collective run inside it, in order:
    (kind, operand shape as c10d takes it, operand bytes) in ``.calls``."""
    from repro_torch.launch.dryrun import _KINDS, _OUT_FIRST, _nbytes
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name.split("::")[-1]
            if name in _KINDS:
                x = args[1] if name in _OUT_FIRST else args[0]
                x = x[0] if isinstance(x, (list, tuple)) else x
                self.calls.append((_KINDS[name], list(x.shape), _nbytes(x)))
            return func(*args, **(kwargs or {}))
    return Calls()


def count_decode_collectives(arch: str, n_layers: tuple, shape, batch: int,
                             seq: int, mla_absorbed: bool = True) -> None:
    """Prints (JSON) the collectives of one tensor-parallel decode step of
    the reduced ``arch`` at each layer count of ``n_layers`` on ``meta``
    over a fake group of a ("data", "model") mesh of ``shape`` (MLA on
    the absorbed or the naive route): per count, each collective's
    (kind, operand shape, operand bytes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.nn import transformer as tfm

    dryrun._fake_group(shape[0] * shape[1])
    plan = mesh_lib.Plan(mesh_lib.make_mesh(shape, ("data", "model"),
                                            "cpu"))
    info = {"kind": "decode", "global_batch": batch, "seq_len": seq}
    out = {}
    for n in n_layers:
        cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n)
        params = tfm.abstract_params(cfg)
        mesh_lib.shard_params(params, plan)
        cache = dryrun._cache_on_plan(cfg, info, plan)
        local = mesh_lib.local_batch(steps.input_specs(cfg, info), plan)
        calls = _calls()
        with calls:
            steps.make_decode_step(cfg, mla_absorbed, plan)(
                params, cache, {"tokens": local["tokens"], "pos": 0})
        out[n] = calls.calls
    print(json.dumps(out))


def count_collectives(arch: str, n_layers: int, shape, batch: int,
                      seq: int, remat: bool) -> None:
    """Prints (JSON) the collectives of one tensor-parallel loss and
    gradient of the reduced ``arch`` at ``n_layers`` layers on ``meta``,
    over a fake group of a ("data", "model") mesh of ``shape``: run in a
    process of its own (the fake group lives for its process)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.nn import transformer as tfm
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                              remat=remat)
    dryrun._fake_group(shape[0] * shape[1])
    plan = mesh_lib.Plan(mesh_lib.make_mesh(shape, ("data", "model"),
                                            "cpu"))
    params = tfm.abstract_params(cfg)
    mesh_lib.shard_params(params, plan)
    info = {"kind": "train", "global_batch": batch, "seq_len": seq}
    local = mesh_lib.local_batch(steps.input_specs(cfg, info), plan)
    counter = dryrun.CollectiveCounter()
    with counter:
        steps._mesh_grads(params, local, cfg, plan)
    print(json.dumps(counter.result()))



def count_step_calls(arch: str, n_layers: tuple, shape, runs: list,
                     batch: int = 4, seq: int = 64) -> None:
    """Prints (JSON) the collectives of tensor-parallel steps of the
    reduced ``arch`` on ``meta`` over a fake group of a ("data", "model")
    mesh of ``shape``, at each layer count of ``n_layers``, for each
    (kind, remat) of ``runs`` (a train step's loss and gradient, a
    prefill or a decode step at ``batch`` x ``seq``): per run and count,
    each collective's (kind, operand shape as c10d takes it, operand
    bytes); and per count each parameter's storage shard shape and the
    dim "data" splits (None where it is whole over "data")."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.nn import transformer as tfm
    from torch.distributed.tensor import Shard

    dryrun._fake_group(shape[0] * shape[1])
    plan = mesh_lib.Plan(mesh_lib.make_mesh(shape, ("data", "model"),
                                            "cpu"))
    out = {}
    for kind, remat in runs:
        info = {"kind": kind, "global_batch": batch, "seq_len": seq}
        for n in n_layers:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      n_layers=n, remat=remat)
            params = tfm.abstract_params(cfg)
            mesh_lib.shard_params(params, plan)
            local = mesh_lib.local_batch(steps.input_specs(cfg, info), plan)
            calls = _calls()
            with calls:
                if kind == "train":
                    steps._mesh_grads(params, local, cfg, plan)
                elif kind == "prefill":
                    steps.make_prefill_step(cfg, plan=plan)(params, local)
                else:
                    cache = dryrun._cache_on_plan(cfg, info, plan)
                    steps.make_decode_step(cfg, plan=plan)(
                        params, cache, {"tokens": local["tokens"], "pos": 0})
            out[f"{kind} {remat} {n}"] = calls.calls
            out[f"leaves {n}"] = {
                k: (list(p.to_local().shape), p.placements[0].dim
                    if isinstance(p.placements[0], Shard) else None)
                for k, p in params.named_parameters()}
    print(json.dumps(out))


def tp_grads(state, cfg, shape, sd, batch):
    """``steps._mesh_grads`` of ``cfg`` from the weights ``sd`` on a
    ("data", "model") mesh of ``shape``, or ("pod", "data", "model") where
    it has three dims (each rank its data shard of ``batch``): (the loss,
    every whole gradient) on rank 0."""
    from repro_torch.launch.steps import _mesh_grads
    axes = ("pod", "data", "model")[-len(shape):]
    plan = mesh_lib.Plan(_mesh(state, shape, axes))
    model = _sharded_lm(cfg, sd, plan)
    loss, grads = _mesh_grads(model, mesh_lib.local_batch(batch, plan), cfg,
                              plan)
    whole = {k: None if g is None else mesh_lib.full(g).clone()
             for k, g in grads.items()}
    return (float(loss), whole) if state["rank"] == 0 else None
