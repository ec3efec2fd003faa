"""Rank tasks of the launcher parity tests (test_torch_compress.py,
test_torch_moe_shardmap.py, test_torch_elastic.py).

A :class:`~repro_torch.core.party_group.PartyGroup` rank unpickles the
task functions it runs by module, so they live here, in a module that
imports ``repro_torch`` and torch only (no rank imports JAX).  Each task
is ``fn(state, *args)`` over the group's gloo ranks and returns CPU
tensors and plain values.
"""
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
