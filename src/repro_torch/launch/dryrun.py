"""Multi-pod dry run: each (arch x shape x mesh) cell's step on ``meta``
tensors over a fake process group of 256 or 512 ranks, allocating
nothing, recording the memory, collectives and roofline of one rank.

Port of ``repro/launch/dryrun.py`` (``dryrun_cell``, ``main``).  The
reference lowers and compiles each cell with XLA on 512 fake host
devices; here this process joins ``torch.distributed``'s "fake" process
group as rank 0 of ``world_size`` ranks (every collective returns at
once), lays the cell's parameters, optimizer state or cache and batch
out as DTensors by ``launch.mesh``'s specs over the production mesh, and
runs the port's own step on them:

* train: ``launch.steps.make_train_step(..., plan)``: the loss
  tensor-parallel over "model" (``launch.tensor_parallel``: H/m heads,
  d_ff/m FFN columns and V/m logits a rank, the residual stream
  sequence-sharded between layers, each layer recomputed in the backward
  pass where ``cfg.remat``), each layer's "model" shards gathered over
  "data" for that layer alone (FSDP storage gathered per layer, again in
  its recomputation), each gradient reduce-scattered back over "data" by
  its gather's backward, AdamW on the shards;
* prefill: ``launch.steps.make_prefill_step(..., plan=plan)``, the same
  tensor-parallel forward on this rank's batch shard, one layer's
  weights gathered at a time;
* decode: ``launch.steps.make_decode_step(..., plan=plan)`` on this
  rank's cache shards (``cache_specs``: its batch shard's S/m positions,
  Mamba-2's H/m heads and C/m conv channels): each layer on its "model"
  shard, gathered over "data" for that layer, the token's projections
  and the attention's softmax combined over "model", nothing of the
  cache gathered (MLA's naive route gathers ``w_uk`` / ``w_uv`` over
  "model" to expand the rank's S/m positions).

Every layer kind of the zoo splits (GQA, MLA and Mamba-2 by heads, GQA
heads that ``m`` does not divide unevenly, MLP columns, MoE experts),
in every step and on both MLA decode routes; ``--no-remat`` (the
reference's flag) runs the cell with ``cfg.remat`` off.

Only the plain versions of the kernels' products run on ``meta``: no
kernel runs in a dry run.

Recorded (the reference's keys): ``status``, ``n_chips``, ``memory``
(``roofline.analyze.summarize_memory``: ``argument_bytes`` exact from
the local shard shapes of the step's inputs, ``output_bytes`` those of
its outputs that are not its inputs, ``temp_bytes`` the rest of the
peak that ``torch.distributed._tools.mem_tracker.MemTracker`` reads),
``collectives`` (per op kind the count and the operand bytes of this
rank's collectives, the keys of the reference's
``collective_bytes_from_hlo``: the per-layer "data" all-gathers and the
gradients' reduce-scatters among them), ``roofline`` and ``step_s`` (the
reference's ``lower_s`` / ``compile_s``: the host seconds of the meta
step).  The roofline is the reference's ``roofline_terms(cfg, shape,
None, collectives, n_chips)``: the cell's work over every chip.  A layer
that does not split over "model" (FFN columns, experts, MLA or Mamba-2
heads that ``m`` does not divide: no cell of the zoo) raises, and the
cell's record is its error.

The fake group lives for the process: run this module as a script, or
through ``launch.farm`` (a subprocess a cell); never call
:func:`dryrun_cell` in a process that needs a real group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single --out dryrun_results/
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, get_config
from ..roofline.analyze import roofline_terms, summarize_memory

__all__ = ["MESHES", "CollectiveCounter", "parse_shape", "dryrun_cell",
           "main"]

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host8": ((2, 4), ("data", "model")),
          "one": ((1, 1), ("data", "model"))}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# torch's collective ops (functional and in-place forms) -> the reference's
# HLO op names
_KINDS = {"all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "_allgather_base_": "all-gather",
          "all_reduce": "all-reduce", "allreduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
          "send": "collective-permute", "recv_": "collective-permute"}
# c10d's ops that take their output first: the operand is the second
_OUT_FIRST = {"allgather_", "_allgather_base_", "reduce_scatter_",
              "_reduce_scatter_base_", "alltoall_base_"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run inside it: ``{op: {"count", "bytes"},
    "total_bytes"}``, the bytes of each collective's operand on this rank
    (the per-chip convention of the reference's
    ``collective_bytes_from_hlo``)."""

    def __init__(self):
        super().__init__()
        self.record = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        kind = _KINDS.get(name)
        if kind is not None:
            self.record[kind]["count"] += 1
            self.record[kind]["bytes"] += _nbytes(
                args[1] if name in _OUT_FIRST else args[0])
        return func(*args, **(kwargs or {}))

    def result(self) -> dict:
        out = {k: dict(v) for k, v in self.record.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.record.values())
        return out


def parse_shape(shape: str) -> tuple[str, dict]:
    """A ``SHAPES`` name, or "kind:global_batch:seq_len" (a cell off the
    table, such as "train:4:256") -> (name, its fields)."""
    if shape in SHAPES:
        return shape, SHAPES[shape]
    kind, b, s = shape.split(":")
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"shape {shape!r}: a SHAPES name or kind:batch:seq")
    return shape, {"kind": kind, "global_batch": int(b), "seq_len": int(s)}


def _fake_group(world: int) -> None:
    """This process as rank 0 of a fake group of ``world`` ranks."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry run needs its own fake group of {world} ranks; "
                f"this process already joined a {dist.get_backend()} group "
                f"of {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _cache_on_plan(cfg, info, plan):
    """The decode cache as DTensors by ``cache_specs``."""
    from ..nn import transformer as tfm
    from . import mesh as mesh_lib
    cache = tfm.abstract_cache(cfg, info["global_batch"], info["seq_len"])
    specs = mesh_lib.cache_specs(cache, plan)

    def lay(tree, spec):
        return {k: lay(v, spec[k]) if isinstance(v, dict)
                else mesh_lib.shard(v, plan, spec[k])
                for k, v in tree.items()}
    return [lay(c, s) for c, s in zip(cache, specs)]


def dryrun_cell(arch: str, shape: str, mesh_kind: str,
                variant: str = "baseline", dispatch: str | None = None,
                ssd_chunk: int = 0, opt_state_dtype: str = "",
                moe_impl: str = "", no_remat: bool = False) -> dict:
    import dataclasses

    from torch.distributed._tools.mem_tracker import MemTracker

    from ..nn import transformer as tfm
    from ..optim import OptConfig, adamw_init
    from . import mesh as mesh_lib
    from . import steps as steps_lib
    from .context import use_plan
    if dispatch:
        from ..nn.moe import set_dispatch_mode
        set_dispatch_mode(dispatch)
    if moe_impl:
        from ..nn.moe import set_moe_impl
        set_moe_impl(moe_impl)
    cfg = get_config(arch)
    if ssd_chunk:
        cfg = dataclasses.replace(cfg, ssd_chunk=ssd_chunk)
    if no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    name, info = parse_shape(shape)
    rec = {"arch": arch, "shape": name, "mesh": mesh_kind,
           "variant": variant, "ts": time.time()}
    if name in SHAPES:
        ok, reason = cfg.shape_supported(name)
        if not ok:
            rec.update(status="SKIP", reason=reason)
            return rec
    dims, axes = MESHES[mesh_kind]
    n_chips = math.prod(dims)
    _fake_group(n_chips)
    mesh = mesh_lib.make_mesh(dims, axes, "cpu")
    plan = mesh_lib.Plan(mesh)
    kind = info["kind"]
    opt_cfg = OptConfig(state_dtype=opt_state_dtype or "fp32")

    params = tfm.abstract_params(cfg)
    mesh_lib.shard_params(params, plan)
    full = steps_lib.input_specs(cfg, info)
    full.pop("pos", None)
    batch = mesh_lib.local_batch(full, plan)
    aux = None
    if kind == "train":
        aux = mesh_lib.conform_opt(
            adamw_init(dict(params.named_parameters()), opt_cfg), params,
            plan)
    elif kind == "decode":
        aux = _cache_on_plan(cfg, info, plan)
    arg_bytes = _local_bytes(dict(params.named_parameters())) \
        + _local_bytes(aux) + _local_bytes(batch)

    tracker = MemTracker()
    tracker.track_external(params, *_locals(aux), *batch.values())
    counter = CollectiveCounter()
    t0 = time.time()
    with tracker, counter, use_plan(plan):
        if kind == "train":
            step = steps_lib.make_train_step(cfg, opt_cfg, plan)
            _, aux, _ = step(params, aux, batch)
            out_bytes = 0      # the state is updated in place
        elif kind == "prefill":
            logits = steps_lib.make_prefill_step(cfg, plan=plan)(params,
                                                                  batch)
            out_bytes = _nbytes(logits)
        else:           # the step writes position 0
            step = steps_lib.make_decode_step(cfg, plan=plan)
            logits, aux = step(params, aux, dict(batch, pos=0))
            out_bytes = _nbytes(logits)
    step_s = time.time() - t0
    # every storage of the step is a ``meta`` one (a DTensor's local
    # tensor); some torch versions' trackers also list the DTensors'
    # own outputs under their mesh's device, at the global shape
    peak = tracker.get_tracker_snapshot("peak").get(
        torch.device("meta"), {}).get("Total", 0)
    colls = counter.result()
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": max(peak - arg_bytes - out_bytes, 0),
           "alias_size_in_bytes": 0}
    rec.update(status="OK", step_s=round(step_s, 2), n_chips=n_chips,
               memory=dict(summarize_memory(mem), tracked_peak_bytes=peak),
               collectives=colls,
               roofline=roofline_terms(cfg, info, None, colls, n_chips))
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    help="a SHAPES name or kind:global_batch:seq_len")
    ap.add_argument("--mesh", default="single", choices=sorted(MESHES))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--dispatch", default=None, choices=[None, "sort",
                                                         "cumsum"])
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--opt-dtype", default="", choices=["", "fp32", "int8"])
    ap.add_argument("--moe-impl", default="", choices=["", "dense",
                                                       "shardmap"])
    ap.add_argument("--no-remat", action="store_true",
                    help="run the cell with cfg.remat off")
    ap.add_argument("--out", default="dryrun_results")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{args.arch}__{args.shape}__{args.mesh}__{args.variant}.json" \
        .replace(":", "-")
    try:
        rec = dryrun_cell(args.arch, args.shape, args.mesh, args.variant,
                          dispatch=args.dispatch, ssd_chunk=args.ssd_chunk,
                          opt_state_dtype=args.opt_dtype,
                          moe_impl=args.moe_impl, no_remat=args.no_remat)
    except Exception as e:  # noqa: BLE001 (a failed cell is a record)
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "variant": args.variant, "status": "FAIL",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    (out_dir / name).write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"},
                     indent=2))
    if rec["status"] == "FAIL":
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
