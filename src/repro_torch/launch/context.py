"""Ambient sharding plan for sharding hints inside model code.

Port of ``repro/launch/context.py`` (``use_plan``, ``current_plan``,
``_resolve``, ``shard_hint``).  Code calls ``shard_hint(x, "batch", None,
"model")`` with logical axis names; with a :class:`~.mesh.Plan` active
(set by the trainer or the dry run) a DTensor is redistributed to the
mesh axes they name, where the dimension divides; with no plan active, or
on a plain tensor, the call returns ``x`` as it is, so single-device code
runs unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["use_plan", "current_plan", "shard_hint"]

_PLAN = contextvars.ContextVar("repro_torch_plan", default=None)


@contextlib.contextmanager
def use_plan(plan):
    tok = _PLAN.set(plan)
    try:
        yield
    finally:
        _PLAN.reset(tok)


def current_plan():
    return _PLAN.get()


def _resolve(plan, logical):
    if logical is None:
        return None
    if logical == "batch":
        ax = plan.batch_axes
        return ax if len(ax) > 1 else ax[0]
    if logical == "seq":
        return "model"
    return logical  # "model", "data" pass through


def shard_hint(x, *logical_axes):
    from torch.distributed.tensor import DTensor
    plan = _PLAN.get()
    if plan is None or not isinstance(x, DTensor) \
            or x.ndim != len(logical_axes):
        return x
    spec = []
    for dim, ax in zip(x.shape, logical_axes):
        mesh_ax = _resolve(plan, ax)
        if mesh_ax is None:
            spec.append(None)
            continue
        size = 1
        for a in (mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)):
            size *= plan._size(a)
        spec.append(mesh_ax if dim % size == 0 else None)
    return x.redistribute(plan.mesh, plan.placements(tuple(spec)))
