"""Training loop with fault tolerance, resume, and straggler accounting.

Port of ``repro/train/trainer.py`` (``TrainerConfig``, ``Trainer``).  The
loop is crash-only: any failure between two checkpoints loses at most
``ckpt_every`` steps; a restart resumes from the manifest, the data-stream
cursor included.  A step slower than ``straggler_factor`` x the EWMA step
time is flagged in the metrics.  Checkpoints hold ``{"params", "opt":
{"m", "v", "step"}}`` in the reference's layout (``weights.lm_tree``), so
either package resumes the other's.

``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and "pod" for
the multi-pod plan) shards the run: every rank of the default process
group runs the same loop; the parameters become DTensors by
``launch.mesh.param_specs`` and the AdamW moments follow ``opt_specs``
(ZeRO-1, int8 moments too); each rank takes its shard of the global batch
(``batch_specs``) and the step is ``launch.steps``' mesh step.  Rank 0
writes the checkpoints (whole tensors, gathered by every rank first), so
a checkpoint written on one mesh restores onto any other, or onto one
device.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from ..configs import ArchConfig
from ..data import token_stream
from ..device import resolve_device
from ..launch import mesh as mesh_lib
from ..launch import steps as steps_lib
from ..nn import transformer as tfm
from ..optim import OptConfig, adamw_init
from ..weights import lm_flat, lm_tree
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 50
    ckpt_dir: str = "ckpts"
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0   # deadline = factor x EWMA step time
    keep_ckpts: int = 3


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 opt_cfg: OptConfig | None = None, mesh=None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or OptConfig()
        self.mesh = mesh
        self.plan = mesh_lib.Plan(mesh) if mesh is not None else None
        self.device = resolve_device(mesh.device_type if mesh is not None
                                     else device)
        self.metrics: list[dict] = []
        self._ewma = None

    # -- state ----------------------------------------------------------
    def init_state(self):
        params = tfm.init_params(self.cfg, self.tcfg.seed, self.device)
        if self.plan is not None:   # the same seed, so the same values
            mesh_lib.shard_params(params, self.plan)
        opt = adamw_init(dict(params.named_parameters()), self.opt_cfg)
        if self.plan is not None:
            opt = mesh_lib.conform_opt(opt, params, self.plan)
        return params, opt

    def _tree(self, params, opt) -> dict:
        """The checkpointed state in the reference's layout (an int8
        moment's ``q8`` / ``s8`` leaves under its parameter's path), whole
        tensors (every rank of a mesh joins the gathers)."""
        def whole(d):
            return {k: mesh_lib.full(v) for k, v in d.items()}
        return {"params": lm_tree(whole(dict(params.named_parameters())),
                                  self.cfg),
                "opt": {"m": lm_tree(whole(_flat_moment(opt["m"])), self.cfg),
                        "v": lm_tree(whole(_flat_moment(opt["v"])), self.cfg),
                        "step": opt["step"]}}

    def _restore(self, params, like):
        """The latest checkpoint into ``params`` (in place) and a new
        optimizer state like ``like``: on a mesh, each whole tensor laid
        out by this trainer's specs (the elastic path)."""
        state, step, _ = restore_checkpoint(self.tcfg.ckpt_dir,
                                            self._tree(params, like))

        def put(v, ref):
            t = torch.from_numpy(v).to(device=self.device, dtype=ref.dtype)
            return mesh_lib.like(t, ref)

        with torch.no_grad():
            for k, v in lm_flat(state["params"], self.cfg).items():
                p = params.get_parameter(k)
                p.copy_(put(v, p))
        opt = {"step": torch.as_tensor(state["opt"]["step"],
                                       device=self.device)}
        for k in ("m", "v"):
            flat = lm_flat(state["opt"][k], self.cfg)
            opt[k] = _nest_moment(flat, like[k], put)
        return params, opt, step

    # -- main loop ------------------------------------------------------
    def run(self, resume: bool = True, fail_at_step: int | None = None):
        """Returns (params, opt, history).  ``fail_at_step`` injects a crash
        (for the fault-tolerance test)."""
        t = self.tcfg
        params, opt = self.init_state()
        start = 0
        if resume and latest_step(t.ckpt_dir) is not None:
            params, opt, start = self._restore(params, opt)
        step_fn = steps_lib.make_train_step(self.cfg, self.opt_cfg,
                                            self.plan)
        stream = token_stream(t.global_batch, t.seq_len, self.cfg.vocab,
                              seed=t.seed, start_step=start)
        for batch, step in stream:
            if step >= t.steps:
                break
            t0 = time.time()
            batch = self._local(batch)
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            dt = time.time() - t0
            self._ewma = dt if self._ewma is None \
                else 0.9 * self._ewma + 0.1 * dt
            rec = {"step": step, "loss": loss, "time_s": round(dt, 4)}
            if dt > t.straggler_factor * self._ewma and step > start + 2:
                rec["straggler"] = True  # deadline breach -> runbook
            self.metrics.append(rec)
            if step % t.log_every == 0 and self._writer:
                print(f"[train] step={step} loss={loss:.4f} dt={dt:.3f}s",
                      flush=True)
            next_step = step + 1
            if next_step % t.ckpt_every == 0 or next_step == t.steps:
                self._save(next_step, params, opt)
            if fail_at_step is not None and next_step >= fail_at_step:
                raise RuntimeError(f"injected failure at step {next_step}")
        if self._writer:
            Path(t.ckpt_dir).mkdir(parents=True, exist_ok=True)
            (Path(t.ckpt_dir) / "metrics.jsonl").write_text(
                "\n".join(json.dumps(m) for m in self.metrics))
        return params, opt, self.metrics

    @property
    def _writer(self) -> bool:
        """Whether this process writes files (rank 0 of a mesh)."""
        import torch.distributed as dist
        return self.plan is None or dist.get_rank() == 0

    def _local(self, batch: dict) -> dict:
        """This rank's shard of a global batch (the whole one without a
        mesh)."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        return batch if self.plan is None \
            else mesh_lib.local_batch(batch, self.plan)

    def _save(self, step: int, params, opt) -> None:
        tree = self._tree(params, opt)
        if self._writer:
            save_checkpoint(self.tcfg.ckpt_dir, step, tree,
                            extra={"arch": self.cfg.name,
                                   "data_cursor": step},
                            keep=self.tcfg.keep_ckpts)
        if self.plan is not None:   # no rank reads a step not yet written
            import torch.distributed as dist
            dist.barrier()


def _flat_moment(moment: dict) -> dict:
    """``{name: tensor or {"q8": .., "s8": ..}}`` -> ``{name[.q8]: tensor}``."""
    flat = {}
    for k, v in moment.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{q}": t for q, t in v.items()})
        else:
            flat[k] = v
    return flat


def _nest_moment(flat: dict, like: dict, put) -> dict:
    """Inverse of :func:`_flat_moment`: each array ``put(array, ref)`` as
    its reference leaf in ``like`` (device, dtype and layout)."""
    return {k: ({q: put(flat[f"{k}.{q}"], r) for q, r in v.items()}
                if isinstance(v, dict) else put(flat[k], v))
            for k, v in like.items()}
