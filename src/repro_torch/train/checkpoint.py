"""Fault-tolerant checkpointing in the reference's on-disk layout.

Port of ``repro/train/checkpoint.py`` (``_flatten``, ``save_checkpoint``,
``latest_step``, ``restore_checkpoint``):

  * atomic: write to <dir>/tmp-<step>-<pid>, fsync, rename to
    <dir>/step-<step:09d>: a crash mid-write never corrupts the latest
    checkpoint;
  * self-describing: manifest.json records step, keys and ``extra`` (the
    arch and the data-stream cursor), so a restarted job resumes
    mid-stream exactly;
  * arrays.npz holds every leaf of a nested dict under its "/"-joined key
    path, the reference's tree paths: a checkpoint either package writes
    restores in the other (the LM's parameters and moments in the
    reference's stacked layout, ``weights.lm_tree``);
  * elastic: arrays are stored whole, with their logical shapes;
    ``restore_checkpoint(..., shardings=)`` lays each one out on whatever
    device mesh the new job runs (a 4-rank checkpoint restores onto 8, or
    onto one device);
  * retention: keep the last N steps (old ones removed only after the new
    one is durable).

The state is a nested dict whose leaves are torch tensors or numpy
arrays; a restore template is the same structure with leaves of the
expected shape and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ..launch.mesh import lay_out
from ..weights import to_host

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]


def _leaves(tree, prefix: str = ""):
    """(key path, leaf) in the reference's order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def save_checkpoint(ckpt_dir, step: int, state: dict, *,
                    extra: dict | None = None, keep: int = 3) -> Path:
    """state: a nested dict of tensors / arrays (params, opt state, ...)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp-{step}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays = {k: to_host(v) for k, v in _leaves(state)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(arrays.keys()), "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    # durability barrier, then atomic publish
    for f in tmp.iterdir():
        with open(f, "rb") as fh:
            os.fsync(fh.fileno())
    final = ckpt_dir / f"step-{step:09d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.name.startswith("step-"))
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("-")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step-")
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def _like(arr: np.ndarray, template):
    """``arr`` as the template leaf's kind, dtype and device."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=template.dtype, device=template.device)
    return arr.astype(template.dtype)


def restore_checkpoint(ckpt_dir, template: dict, *, step: int | None = None,
                       shardings: dict | None = None):
    """Rebuild a ``template``-shaped nested dict from disk (the latest step
    unless ``step`` is given).  Returns ``(state, step, extra)``, or
    ``(None, None, None)`` when there is no checkpoint; raises
    ``ValueError`` on a leaf whose shape differs from the template's.

    ``shardings``: a nested dict matching ``template`` whose leaves are
    ``(mesh, placements)`` pairs (a ``DeviceMesh`` and one DTensor
    placement a mesh dimension) or None: such a leaf comes back as a
    DTensor on that mesh, each rank keeping its own slices (every rank
    reads the file) — the elastic-reshape path."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None, None
    d = ckpt_dir / f"step-{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        def rebuild(tree, sh, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, None if sh is None else sh[k],
                                   f"{prefix}{k}/")
                        for k, v in tree.items()}
            key = prefix[:-1]
            arr = arrays[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs expected "
                                 f"{tuple(tree.shape)}")
            out = _like(arr, tree)
            return out if sh is None else _place(out, *sh)
        state = rebuild(template, shardings)
    return state, step, manifest.get("extra", {})


def _place(leaf, mesh, placements):
    """A whole array or tensor (the same on every rank) as a DTensor."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    return lay_out(t.to(mesh.device_type), mesh, tuple(placements))
