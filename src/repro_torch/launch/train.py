"""Training launcher: the LM trainer on one device.

Port of ``repro/launch/train.py``.  Runs on the card unless ``--device
cpu`` is given, and resumes from the latest checkpoint in ``--ckpt-dir``
when there is one; ``--mesh`` other than ``none`` raises until the sharded
plan is ported (ROADMAP.md §A item 8).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 [--reduced] [--device cpu] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..train import Trainer, TrainerConfig

__all__ = ["main"]


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
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the sharded plan (launch/mesh.py) is not "
            f"ported yet (ROADMAP.md §A item 8)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                         seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    _, _, metrics = Trainer(cfg, tcfg, device=args.device).run()
    print(f"[train] finished {len(metrics)} steps; "
          f"final loss {metrics[-1]['loss']:.4f}")
    return metrics


if __name__ == "__main__":
    main()
