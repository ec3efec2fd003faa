"""Training launcher: the LM trainer on one device or a device mesh.

Port of ``repro/launch/train.py``.  Runs on the card unless ``--device
cpu`` is given, and resumes from the latest checkpoint in ``--ckpt-dir``
when there is one.  ``--mesh``:

* ``none``: one device;
* ``host8``: 8 gloo ranks on the host CPU, a (2, 4) ("data", "model")
  mesh (the reference's 8 fake host devices);
* ``single`` / ``multi``: the production mesh, (16, 16) or (2, 16, 16),
  over the process group ``torchrun`` sets up (``WORLD_SIZE``,
  ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: 256 or 512 ranks).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 50 [--reduced] [--device cpu] [--ckpt-dir DIR] [--mesh host8]
"""
from __future__ import annotations

import argparse
import os

from ..configs import get_config
from ..train import Trainer, TrainerConfig

__all__ = ["main"]

HOST_MESH = (2, 4)
PRODUCTION_RANKS = {"single": 256, "multi": 512}


def _rank_train(state, cfg, tcfg, shape) -> list:
    """One rank of a host mesh: the trainer on a ("data", "model") mesh
    of ``shape`` over the group's gloo ranks; returns the metrics."""
    from . import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
    return Trainer(cfg, tcfg, mesh=mesh).run()[2]


def _production(kind: str, tcfg, cfg, device) -> list:
    import torch.distributed as dist

    from . import mesh as mesh_lib
    need = PRODUCTION_RANKS[kind]
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != need:
        raise RuntimeError(
            f"--mesh {kind} runs on {need} ranks, one a device, started by "
            f"torchrun (torchrun --nproc-per-node ... --nnodes ...); this "
            f"process sees WORLD_SIZE={world}")
    if not dist.is_initialized():
        dist.init_process_group()
    mesh = mesh_lib.make_production_mesh(multi_pod=kind == "multi",
                                         device_type=device)
    return Trainer(cfg, tcfg, mesh=mesh).run()[2]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi", "host8"])
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                         seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    if args.mesh == "host8":
        from ..core.party_group import PartyGroup
        n = HOST_MESH[0] * HOST_MESH[1]
        with PartyGroup("cpu", timeout=600, deadline=24 * 3600,
                        ranks=n) as g:
            metrics = g.run(_rank_train, (cfg, tcfg, HOST_MESH))[0]
    elif args.mesh in PRODUCTION_RANKS:
        metrics = _production(args.mesh, tcfg, cfg, args.device)
    else:
        metrics = Trainer(cfg, tcfg, device=args.device).run()[2]
    print(f"[train] finished {len(metrics)} steps; "
          f"final loss {metrics[-1]['loss']:.4f}")
    return metrics


if __name__ == "__main__":
    main()
