"""Device meshes and partition-spec rules (DP/FSDP + TP/EP + pod-DP).

Port of ``repro/launch/mesh.py`` (``make_production_mesh``, ``make_mesh``,
``Plan``, ``_leaf_spec``, ``to_shardings`` as :func:`to_placements`,
``param_specs``, ``opt_specs``, ``batch_specs``, ``cache_specs``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names; a spec is a tuple with one entry a tensor dimension, each a mesh
axis name, a tuple of names, or None (the reference's ``PartitionSpec``),
and :func:`to_placements` turns it into DTensor ``Shard`` / ``Replicate``
placements.

Sharding scheme (the reference's):
  * batch          -> ("pod", "data") as divisibility allows;
  * weight matrices -> one dim over "data" (FSDP storage) and one over
    "model" (Megatron-style TP; MoE experts shard their E axis over
    "model");
  * optimizer state -> the parameter's spec (ZeRO-1: the "data" axis in
    the parameter spec shards the moments too);
  * KV caches      -> batch over "data", sequence over "model".

The port's parameters are one tensor a layer (``layers.{j}.{name}``, as
``weights.lm_flat`` names the reference's stacked leaves), so a layer
leaf's spec is the reference's spec of the stacked leaf without its
leading layer axis; a cache is one dict a layer, likewise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import torch

__all__ = ["make_production_mesh", "make_mesh", "Plan", "to_placements",
           "param_specs", "opt_specs", "batch_specs", "cache_specs",
           "lay_out", "shard", "like", "shard_params", "conform", "conform_opt", "local_batch",
           "model_dim", "model_shard", "redistribute", "full"]


def _device_type() -> str:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        return "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group (its world size must be the mesh's size);
    ``device_type`` defaults to "cuda" where a card is visible."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Axis-name view of a mesh."""
    mesh: object

    def _size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def has_pod(self) -> bool:
        return "pod" in self.mesh.mesh_dim_names

    @property
    def data_size(self) -> int:
        return self._size("data")

    @property
    def model_size(self) -> int:
        return self._size("model")

    @property
    def batch_axes(self) -> tuple:
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def batch_size_div(self) -> int:
        n = self.data_size
        if self.has_pod:
            n *= self._size("pod")
        return n

    def batch_spec_axes(self, b: int):
        """Largest batch sharding the divisibility allows."""
        if b % self.batch_size_div == 0:
            ax = self.batch_axes
            return ax if len(ax) > 1 else ax[0]
        if b % self.data_size == 0:
            return "data"
        return None

    def placements(self, spec: tuple) -> tuple:
        return to_placements(spec, self.mesh)


def to_placements(spec: tuple, mesh) -> tuple:
    """A spec -> one DTensor placement a mesh dimension: ``Shard(d)`` where
    tensor dim d names the mesh axis (a tuple of axes shards d over each,
    major first), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------------------
# Param partition rules
# ---------------------------------------------------------------------------

_IN_MATS = {"wq", "wk", "wv", "w_up", "w_gate", "w_in", "w_dq", "w_uq",
            "w_uk", "w_uv", "w_dkv", "w_kr", "router"}
_OUT_MATS = {"wo", "w_down", "w_out"}
_HEAD_VECS = {"A_log", "D", "dt_bias", "norm_g"}


def _leaf_spec(name: str, rank: int, shape, plan: Plan) -> tuple:
    """The reference's rule for a leaf of the reference's layout (layer
    leaves stacked on a leading axis)."""
    def fits(dim_idx, axis_size):
        return shape[dim_idx] % axis_size == 0

    d, m = plan.data_size, plan.model_size
    if name == "embed":
        return ("model", "data") if fits(0, m) and fits(1, d) else ()
    if name in ("head", "front_proj", "mtp_proj"):
        return ("data", "model") if fits(0, d) and fits(1, m) else ()

    if name in _IN_MATS:
        if rank == 4:  # (L, E, din, dout) MoE expert stack
            return (None, "model" if fits(1, m) else None,
                    "data" if fits(2, d) else None, None)
        if rank == 3:  # (L, din, dout)
            return (None, "data" if fits(1, d) else None,
                    "model" if fits(2, m) else None)
        if rank == 2:  # unstacked
            return ("data" if fits(0, d) else None,
                    "model" if fits(1, m) else None)
    if name in _OUT_MATS:
        if rank == 4:  # (L, E, dff, d)
            return (None, "model" if fits(1, m) else None, None,
                    "data" if fits(3, d) else None)
        if rank == 3:
            return (None, "model" if fits(1, m) else None,
                    "data" if fits(2, d) else None)
        if rank == 2:
            return ("model" if fits(0, m) else None,
                    "data" if fits(1, d) else None)
    if name == "conv_w" and rank == 3:  # (L, K, C)
        return (None, None, "model" if fits(2, m) else None)
    if name in _HEAD_VECS and rank == 2:  # (L, H) / (L, d_inner)
        return (None, "model" if fits(1, m) else None)
    return ()  # replicated (norm vectors, scalars, tiny leaves)


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def param_specs(params, plan: Plan) -> dict:
    """``{name: spec}`` for an ``LM`` (or its ``{name: tensor}`` map): a
    ``layers.{j}.*`` leaf takes the spec of the reference's stacked leaf
    without the layer axis, any other leaf the reference's spec."""
    out = {}
    for k, p in _named(params).items():
        name = k.rsplit(".", 1)[-1]
        if k.startswith("layers."):
            spec = _leaf_spec(name, p.ndim + 1, (1,) + tuple(p.shape), plan)
            out[k] = tuple(spec[1:])
        else:
            out[k] = _leaf_spec(name, p.ndim, tuple(p.shape), plan)
    return out


def opt_specs(opt_state: dict, p_specs: dict) -> dict:
    """ZeRO-1: the moments take their parameter's spec; the step is
    replicated.  An int8 moment (``{"q8"/"qu8", "s8"/"su8"}``) shards its
    payload like the parameter and its per-row scales like the parameter
    without its last axis."""
    def moment(leaf, ps):
        if not isinstance(leaf, dict):
            return ps
        scale = tuple(ps[:-1]) + (None,) if len(ps) else ()
        return {k: ps if k in ("q8", "qu8") else scale for k in leaf}

    return {"m": {k: moment(v, p_specs[k])
                  for k, v in opt_state["m"].items()},
            "v": {k: moment(v, p_specs[k])
                  for k, v in opt_state["v"].items()},
            "step": ()}


def batch_specs(batch: dict, plan: Plan) -> dict:
    """The batch axis as :meth:`Plan.batch_spec_axes` allows; 0-d leaves
    (a decode position) replicated."""
    def spec(leaf):
        if leaf.ndim == 0:
            return ()
        return (plan.batch_spec_axes(leaf.shape[0]),) \
            + (None,) * (leaf.ndim - 1)
    return {k: spec(v) for k, v in batch.items()}


def _cache_leaf(name: str, shape, plan: Plan) -> tuple:
    """A layer's cache leaf (the reference's stacked leaf without L)."""
    d, m = plan.data_size, plan.model_size
    if name in ("k", "v", "c_kv", "k_rope"):   # (B, S, ...): seq over model
        return ("data" if shape[0] % d == 0 else None,
                "model" if shape[1] % m == 0 else None) \
            + (None,) * (len(shape) - 2)
    if name == "state":  # (B, H, hd, N)
        return ("data" if shape[0] % d == 0 else None,
                "model" if shape[1] % m == 0 else None, None, None)
    if name == "conv":  # (B, K-1, C)
        return ("data" if shape[0] % d == 0 else None, None,
                "model" if shape[2] % m == 0 else None)
    return ()


def cache_specs(cache: list, plan: Plan) -> list:
    """Specs mirroring the port's cache (one dict a layer, jamba's
    sub-layer dicts nested)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else _cache_leaf(k, tuple(v.shape), plan)
                for k, v in tree.items()}
    return [walk(layer) for layer in cache]


# ---------------------------------------------------------------------------
# Laying tensors out on a plan
# ---------------------------------------------------------------------------

def lay_out(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t`` (the same whole tensor on every rank) on ``mesh``
    with ``placements``: each rank keeps its own slices, no message
    moves."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


def shard(t: torch.Tensor, plan: Plan, spec: tuple):
    """A DTensor of ``t`` (the same whole tensor on every rank) laid out by
    ``spec`` (:func:`lay_out`)."""
    return lay_out(t, plan.mesh, plan.placements(spec))


def like(t: torch.Tensor, ref):
    """``t`` (whole, the same on every rank) laid out as the DTensor
    ``ref``, or ``t`` itself when ``ref`` is a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return t
    return lay_out(t, ref.device_mesh, ref.placements)


def shard_params(module: torch.nn.Module, plan: Plan) -> dict:
    """Replace every parameter of ``module`` (the same values on every
    rank) by its DTensor under :func:`param_specs`; returns the specs."""
    specs = param_specs(module, plan)
    for k, spec in specs.items():
        owner, _, leaf = k.rpartition(".")
        mod = module.get_submodule(owner)
        p = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            shard(p.detach(), plan, spec), requires_grad=False))
    return specs


def conform(tree, specs, plan: Plan):
    """Every DTensor of a nested dict redistributed to the placements of
    the matching spec of ``specs`` (a no-op where they already agree)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: conform(v, specs[k], plan) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.redistribute(plan.mesh, plan.placements(specs))
    return tree


def conform_opt(opt_state: dict, params, plan: Plan) -> dict:
    """An AdamW state laid out by :func:`opt_specs` of ``params``' specs
    (the int8 moments' row scales come back from their row maxima as
    partial or replicated tensors)."""
    return conform(opt_state, opt_specs(opt_state, param_specs(params,
                                                               plan)), plan)


def local_batch(batch: dict, plan: Plan) -> dict:
    """This rank's shard of a whole batch (the same on every rank) under
    :func:`batch_specs`, as plain tensors."""
    specs = batch_specs(batch, plan)
    return {k: shard(v, plan, specs[k]).to_local() for k, v in batch.items()}


@functools.cache
def _host_twin(mesh):
    """``mesh``'s ranks and process groups as a "cpu" ``DeviceMesh`` (no
    new group is made: no collective)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh.from_group(
        [mesh.get_group(i) for i in range(mesh.ndim)], "cpu",
        mesh=mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)


def redistribute(x, placements):
    """The DTensor ``x`` laid out by ``placements`` (the collectives every
    rank joins).  Where they differ only on mesh dims of one rank, the
    local tensor is already the answer and nothing moves.  On a CUDA mesh
    over gloo (ranks sharing one card: NCCL refuses them) the shards move
    as host copies: torch's functional collectives, which DTensor uses,
    crash the ranks on CUDA tensors over gloo."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    placements = tuple(placements)
    if placements == tuple(x.placements):
        return x
    if all(a == b or mesh.size(i) == 1 for i, (a, b) in
           enumerate(zip(x.placements, placements))):
        # only mesh dims of one rank differ: the same local tensor
        return DTensor.from_local(x.to_local(), mesh, placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    if mesh.device_type != "cuda" \
            or dist.get_backend(mesh.get_group(0)) != dist.Backend.GLOO:
        return x.redistribute(mesh, placements)
    host = DTensor.from_local(x.to_local().cpu(), _host_twin(mesh),
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())
    out = host.redistribute(host.device_mesh, placements).to_local()
    return DTensor.from_local(out.to(x.device), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def full(x):
    """The whole tensor of a DTensor (an all-gather every rank joins), or
    ``x`` itself (:func:`redistribute`)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def model_dim(x):
    """The tensor dim a DTensor is sharded along over "model", or None."""
    from torch.distributed.tensor import Shard
    pl = x.placements[x.device_mesh.mesh_dim_names.index("model")]
    return pl.dim if isinstance(pl, Shard) else None


def model_shard(x):
    """A DTensor's "model" shard as a plain tensor: every other mesh axis
    gathered, the "model" one kept (a whole gradient's shard; the steps
    gather parameters one layer at a time instead,
    ``tensor_parallel.gathered``)."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    keep = x.placements[names.index("model")]
    return redistribute(x, [keep if a == "model" else Replicate()
                            for a in names]).to_local()
