"""End-to-end CBNN customization command line (paper Figs. 5/6 + Tables 1-2):

  teacher (full-precision, ReLU)  -->  KD  -->  customized BNN students
  (Sign activations, optionally MPC-friendly separable convs)  -->
  compile_secure in every §11 weight/path mode  -->  the
  accuracy-vs-online-bytes Pareto frontier.

Port of ``examples/distill_cbnn.py``.  Prints the reference's table; writes
the rows as JSON only to the path ``--out`` names.  Runs on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.distill [--epochs 2] \
      [--quick] [--secure-eval N] [--out PATH] [--device cpu]

``--quick``: one epoch on 768 training and 256 test images, secure
accuracy on 32 of them.  Data is synthetic (DESIGN.md §9), so accuracies
separate the variants relatively; they are not the paper's MNIST/CIFAR
numbers.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from ..distill import run_pipeline

__all__ = ["main"]


def _print_rows(result: dict) -> None:
    rows = result["rows"]
    print(f"\n{'net':14s} {'conv':9s} {'mode':7s} {'params':>9s} "
          f"{'acc':>6s} {'sec':>6s} {'KB/query':>9s} {'rounds':>6s} "
          f"{'WAN s':>7s}  pareto")
    for r in rows:
        sec = f"{r['secure_acc']:.3f}" if r["secure_acc"] is not None else "-"
        print(f"{r['net']:14s} {r['conv']:9s} {r['mode']:7s} "
              f"{r['params']:9d} {r['acc']:6.3f} {sec:>6s} "
              f"{r['online_kb']:9.1f} {r['rounds']:6d} {r['wan_s']:7.3f}  "
              f"{'*' if r['pareto'] else ''}")
    # the paper's customization claim, stated on this frontier: the
    # separable student should not be dominated (less traffic at
    # comparable accuracy)
    for mode in result["meta"]["modes"]:
        sep = [r for r in rows if r["mode"] == mode
               and r["conv"] == "separable" and r["pareto"]]
        if sep:
            names = ", ".join(r["net"] for r in sep)
            print(f"  [{mode}] separable students on the frontier: {names}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--temperature", type=float, default=10.0)
    ap.add_argument("--secure-eval", type=int, default=64,
                    help="eval-set size for secure accuracy (shared mode); "
                         "negative = all modes; 0 = skip")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON here (nothing is written "
                         "without it)")
    ap.add_argument("--quick", action="store_true",
                    help="1 epoch on a small subset")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    kw = dict(epochs=args.epochs, lam=args.lam, temperature=args.temperature,
              secure_eval_size=args.secure_eval, device=args.device)
    if args.quick:
        kw.update(epochs=1, train_size=768, test_size=256,
                  secure_eval_size=32)
    result = run_pipeline(**kw)
    _print_rows(result)
    if args.out:
        out = pathlib.Path(args.out)
        out.write_text(json.dumps(result, indent=1))
        print(f"\nwrote {len(result['rows'])} rows -> {out}")
    return result


if __name__ == "__main__":
    main()
