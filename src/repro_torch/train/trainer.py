"""Training loop with fault tolerance, resume, and straggler accounting.

Port of ``repro/train/trainer.py`` (``TrainerConfig``, ``Trainer``) on one
device: ``mesh=None`` only (the sharded plan waits for ``launch/mesh.py``,
ROADMAP.md §A item 8).  The loop is crash-only: any failure between two
checkpoints loses at most ``ckpt_every`` steps; a restart resumes from the
manifest, the data-stream cursor included.  A step slower than
``straggler_factor`` x the EWMA step time is flagged in the metrics.
Checkpoints hold ``{"params", "opt": {"m", "v", "step"}}`` in the
reference's layout (``weights.lm_tree``), so either package resumes the
other's.
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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the sharded plan (launch/mesh.py) is not "
                "ported yet (ROADMAP.md §A item 8)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or OptConfig()
        self.device = resolve_device(device)
        self.metrics: list[dict] = []
        self._ewma = None

    # -- state ----------------------------------------------------------
    def init_state(self):
        params = tfm.init_params(self.cfg, self.tcfg.seed, self.device)
        return params, adamw_init(dict(params.named_parameters()),
                                  self.opt_cfg)

    def _tree(self, params, opt) -> dict:
        """The checkpointed state in the reference's layout (an int8
        moment's ``q8`` / ``s8`` leaves under its parameter's path)."""
        return {"params": lm_tree(dict(params.named_parameters()), self.cfg),
                "opt": {"m": lm_tree(_flat_moment(opt["m"]), self.cfg),
                        "v": lm_tree(_flat_moment(opt["v"]), self.cfg),
                        "step": opt["step"]}}

    def _restore(self, params, like):
        state, step, _ = restore_checkpoint(self.tcfg.ckpt_dir,
                                            self._tree(params, like))
        with torch.no_grad():
            for k, v in lm_flat(state["params"], self.cfg).items():
                params.get_parameter(k).copy_(torch.from_numpy(v))
        opt = {"step": torch.as_tensor(state["opt"]["step"],
                                       device=self.device)}
        for k in ("m", "v"):
            flat = lm_flat(state["opt"][k], self.cfg)
            opt[k] = _nest_moment({n: torch.from_numpy(v)
                                   for n, v in flat.items()}, like[k])
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
        step_fn = steps_lib.make_train_step(self.cfg, self.opt_cfg)
        stream = token_stream(t.global_batch, t.seq_len, self.cfg.vocab,
                              seed=t.seed, start_step=start)
        for batch, step in stream:
            if step >= t.steps:
                break
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            dt = time.time() - t0
            self._ewma = dt if self._ewma is None \
                else 0.9 * self._ewma + 0.1 * dt
            rec = {"step": step, "loss": loss, "time_s": round(dt, 4)}
            if dt > t.straggler_factor * self._ewma and step > start + 2:
                rec["straggler"] = True  # deadline breach -> runbook
            self.metrics.append(rec)
            if step % t.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} dt={dt:.3f}s",
                      flush=True)
            next_step = step + 1
            if next_step % t.ckpt_every == 0 or next_step == t.steps:
                save_checkpoint(t.ckpt_dir, next_step,
                                self._tree(params, opt),
                                extra={"arch": self.cfg.name,
                                       "data_cursor": next_step},
                                keep=t.keep_ckpts)
            if fail_at_step is not None and next_step >= fail_at_step:
                raise RuntimeError(f"injected failure at step {next_step}")
        Path(t.ckpt_dir).mkdir(parents=True, exist_ok=True)
        (Path(t.ckpt_dir) / "metrics.jsonl").write_text(
            "\n".join(json.dumps(m) for m in self.metrics))
        return params, opt, self.metrics


def _flat_moment(moment: dict) -> dict:
    """``{name: tensor or {"q8": .., "s8": ..}}`` -> ``{name[.q8]: tensor}``."""
    flat = {}
    for k, v in moment.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{q}": t for q, t in v.items()})
        else:
            flat[k] = v
    return flat


def _nest_moment(flat: dict, like: dict) -> dict:
    """Inverse of :func:`_flat_moment`, each tensor on ``like``'s device and
    in its dtype."""
    def cast(t, ref):
        return t.to(device=ref.device, dtype=ref.dtype)
    return {k: ({q: cast(flat[f"{k}.{q}"], r) for q, r in v.items()}
                if isinstance(v, dict) else cast(flat[k], v))
            for k, v in like.items()}
