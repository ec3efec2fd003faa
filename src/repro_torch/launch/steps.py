"""Step functions of the plaintext LM path (train, prefill, decode).

Port of ``repro/launch/steps.py`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``).  The train step takes the
gradient of ``nn.transformer.loss_fn`` with respect to every parameter of
the ``LM`` module (``nn.layers.trainable`` turns gradients on for the step
only) and applies ``optim.adamw_update`` in place.  The prefill and decode
steps run without autograd.  ``input_specs`` and ``abstract_state`` give
every model input and the state of a ``configs.SHAPES`` cell as ``meta``
tensors (the reference's shapes, the port's dtypes), for the dry run.
"""
from __future__ import annotations

import torch

from ..configs import ArchConfig
from ..nn import transformer as tfm
from ..nn.layers import COMPUTE_DTYPE, trainable
from ..optim import OptConfig, adamw_init, adamw_update
from ..roofline.analyze import shape_info

__all__ = ["input_specs", "abstract_state", "make_train_step",
           "make_prefill_step", "make_decode_step"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """``meta`` stand-ins for every model input of this cell (a ``SHAPES``
    name, or a dict of its ``kind``, ``global_batch`` and ``seq_len``): a
    train or prefill batch ("tokens", or "frames" / "patch_embeds" +
    "tokens" for a frontend, and "labels" to train); a decode step's
    (B, 1) tokens and 0-d position."""
    b, s, kind = shape_info(shape_name)
    if kind in ("train", "prefill"):
        batch = {}
        if cfg.frontend == "audio":
            batch["frames"] = _meta((b, s, cfg.d_model), COMPUTE_DTYPE)
        elif cfg.frontend == "vision":
            batch["tokens"] = _meta((b, s - cfg.n_patches), torch.int32)
            batch["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                          COMPUTE_DTYPE)
        else:
            batch["tokens"] = _meta((b, s), torch.int32)
        if kind == "train":
            lab_s = s - cfg.n_patches if cfg.frontend == "vision" else s
            batch["labels"] = _meta((b, lab_s), torch.int32)
        return batch
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def abstract_state(cfg: ArchConfig, shape_name,
                   opt_cfg: OptConfig | None = None):
    """(the ``LM`` on ``meta``, its AdamW state / decode cache / None) for
    this cell: the optimizer state for a train cell, the cache of
    ``seq_len`` positions for a decode cell."""
    params = tfm.abstract_params(cfg)
    b, s, kind = shape_info(shape_name)
    if kind == "train":
        return params, adamw_init(dict(params.named_parameters()), opt_cfg)
    if kind == "decode":
        return params, tfm.abstract_cache(cfg, b, s)
    return params, None


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig | None = None,
                    plan=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``params`` is the ``LM`` module, updated in
    place and returned; ``opt_state`` is ``optim.adamw_init`` of
    ``dict(params.named_parameters())``; ``batch`` holds "labels" and the
    model's inputs (``nn.transformer.loss_fn``: "tokens", and "frames" or
    "patch_embeds" for a frontend).  The metrics are 0-d device
    tensors.

    With a ``plan`` (a ``launch.mesh.Plan``) the parameters and moments
    are DTensors laid out by ``mesh.param_specs`` / ``opt_specs`` and
    ``batch`` is this rank's shard (``mesh.batch_specs``): the step runs
    the loss tensor-parallel over "model" (``launch.tensor_parallel``,
    see :func:`_mesh_grads`), each layer's "model" shards gathered over
    "data" for that layer (FSDP storage gathered per layer), its
    gradients reduce-scattered back over "data" to the parameters'
    layout, and AdamW on the shards; the loss is the mean over the data
    shards."""
    opt_cfg = opt_cfg or OptConfig()
    if plan is not None:
        return _mesh_train_step(cfg, opt_cfg, plan)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with trainable(params) as leaves:
            loss = tfm.loss_fn(params, batch, cfg)
            # hubert's loss never reads its token embedding: None, which
            # adamw_update takes as zeros (the reference's gradient)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        _, opt_state, gnorm = adamw_update(
            named, dict(zip(named, grads)), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def _mesh_grads(params, batch: dict, cfg: ArchConfig, plan):
    """(loss of this rank's data shard, DTensor gradients in the
    parameters' layouts).  The ranks of a "model" row share their data
    shard and one loss, computed tensor-parallel on the parameters'
    storage shards (``tensor_parallel.local_params``), each layer's
    gathered over "data" for that layer (``tensor_parallel.gathered``);
    each local gradient is complete for its shard over "model" (the
    conjugate collectives sum the row's contributions: the MoE
    all-to-all's too) and partial over the n data ranks ("data", "pod"),
    so each rank differentiates its loss over n, and each gather's
    backward reduce-scatters its leaf's gradient over "data" (all-reduces
    a leaf whole over it): it comes back in the parameter's own
    placements, summed once.  The backward pass runs inside the plan
    (remat recomputes layers, and their gathers, there)."""
    from torch.distributed.tensor import DTensor

    from . import tensor_parallel as tp
    from .context import use_plan
    mesh = plan.mesh
    n_data = mesh.size() // plan.model_size
    named = dict(params.named_parameters())
    with tp.local_params(params, plan, tp.stream_len(batch, cfg),
                         grad=True) as (local, _), use_plan(plan):
        loss = tfm.loss_fn(params, batch, cfg)
        # hubert's loss never reads its token embedding: None (zeros)
        grads = torch.autograd.grad(loss / n_data, list(local.values()),
                                    allow_unused=True)
        summed = [tp.reduced(t) for t in local.values()]
    out = {}
    for (k, p), g, done in zip(named.items(), grads, summed):
        if g is not None and not done:
            raise RuntimeError(f"{k} was read outside "
                               f"tensor_parallel.gathered: its gradient "
                               f"is not summed over the data ranks")
        out[k] = None if g is None else DTensor.from_local(
            g, mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride())
    return loss.detach(), out


def _mesh_train_step(cfg: ArchConfig, opt_cfg: OptConfig, plan):
    from torch.distributed.tensor import DTensor, Partial

    from . import mesh as mesh_lib

    def train_step(params, opt_state, batch):
        loss, grads = _mesh_grads(params, batch, cfg, plan)
        named = dict(params.named_parameters())
        _, opt_state, gnorm = adamw_update(named, grads, opt_state, opt_cfg)
        opt_state = mesh_lib.conform_opt(opt_state, params, plan)
        mesh = plan.mesh
        mean = mesh_lib.full(DTensor.from_local(
            loss.reshape(()), mesh, [Partial()] * mesh.ndim,
            run_check=False)) / mesh.size()
        return params, opt_state, {"loss": mean,
                                   "grad_norm": mesh_lib.full(gnorm)}

    return train_step


def make_prefill_step(cfg: ArchConfig, flash_impl=None, plan=None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits of
    the batch's inputs ("tokens", "frames" or "patch_embeds" + "tokens");
    ``flash_impl`` (e.g. ``kernels.ops.flash_attention_op``) takes the
    causal GQA attention of every layer (never MLA's, nor an encoder's).
    With a ``plan`` the parameters are DTensors by ``mesh.param_specs``
    and ``batch`` is this rank's data shard: the step runs tensor-parallel
    over "model" (the flash hook on the rank's heads), each layer's
    "model" shards gathered over "data" for that layer, and returns the
    shard's logits."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if plan is None:
            return tfm.prefill_step(params, batch, cfg, flash_impl)
        from . import tensor_parallel as tp
        from .context import use_plan
        with tp.local_params(params, plan, tp.stream_len(batch, cfg)), \
                use_plan(plan):
            return tfm.prefill_step(params, batch, cfg, flash_impl)
    return prefill_step


def _cache_shards(cache, plan) -> list:
    """This rank's shards of a cache of DTensors laid out by
    ``mesh.cache_specs`` (plain tensors; the in-place writes of a decode
    step land in the DTensors' storage).  A sequence leaf (k, v, c_kv,
    k_rope) must be split over "model" where "model" has more than one
    rank: a decode step attends over its rank's slice of positions."""
    from . import mesh as mesh_lib

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            if plan.model_size > 1 and k in ("k", "v", "c_kv", "k_rope") \
                    and mesh_lib.model_dim(v) != 1:
                raise ValueError(
                    f"cache leaf {k} {tuple(v.shape)}: its sequence does not "
                    f"split over {plan.model_size} model ranks")
            out[k] = v.to_local()
        return out
    return [walk(c) for c in cache]


def _cache_like(local: list, cache: list) -> list:
    """The step's new shards as DTensors laid out as ``cache``."""
    from torch.distributed.tensor import DTensor

    def walk(tree, like):
        return {k: walk(v, like[k]) if isinstance(v, dict)
                else DTensor.from_local(v, like[k].device_mesh,
                                        like[k].placements, run_check=False,
                                        shape=like[k].shape,
                                        stride=like[k].stride())
                for k, v in tree.items()}
    return [walk(t, c) for t, c in zip(local, cache)]


def make_decode_step(cfg: ArchConfig, mla_absorbed: bool = True,
                     plan=None):
    """``serve_step(params, cache, {"tokens": (B,1), "pos": int}) ->
    (logits (B,1,V), cache)``; MLA layers decode absorbed (the default)
    or naive.  With a ``plan`` the parameters are DTensors by
    ``mesh.param_specs``, the cache DTensors by ``mesh.cache_specs`` and
    "tokens" this rank's data shard: the step runs tensor-parallel over
    "model" on the rank's parameter and cache shards (each layer's
    gathered over "data" for that layer; each rank attends over its S/m
    positions; the owner of ``pos`` writes them) and returns
    the shard's logits, whole over the vocabulary, and the cache in its
    layout."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        if plan is None:
            return tfm.decode_step(params, cache, batch["tokens"],
                                   batch["pos"], cfg,
                                   mla_absorbed=mla_absorbed)
        from . import tensor_parallel as tp
        from .context import use_plan
        with tp.local_params(params, plan, 1), use_plan(plan):
            logits, local = tfm.decode_step(
                params, _cache_shards(cache, plan), batch["tokens"],
                batch["pos"], cfg, mla_absorbed=mla_absorbed)
        return logits, _cache_like(local, cache)
    return serve_step
