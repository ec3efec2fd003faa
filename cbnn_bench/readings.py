"""The readings a cell's correctness limit is set from, on the card.

  python3 cbnn_bench/readings.py --workload cifarnet7-inline-b128 \\
      --seeds 11,12,13 --seconds 45 [--control-only]

For each seed, in one process: a run of the cell as the benchmark runs it
(the program's ``logit_gap`` over every query of a ``--seconds`` window),
and the control: the plain reference in bfloat16 put in the program's
place, at the cell's own batch and images, against the float64 reference.
Prints one line a seed.  The benchmark's own runs never run this.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def control_gap(workload: str, seed: int, device="cuda") -> float:
    """``logit_gap`` of the bfloat16 reference in the program's place."""
    import torch

    from cbnn_bench.harness import check, inputs, manifest
    _, cfg, traffic = manifest.cell(manifest.load(), workload)
    images = inputs.make_images(cfg, traffic["batch"],
                                traffic["distinct_batches"], seed, device)
    params = inputs.make_params(cfg, seed, device, images.flatten(0, 1))
    refs = check.reference_logits(cfg, params, images)
    ctrl = check.reference_logits(cfg, params, images, torch.bfloat16)
    return max(check.compare(cfg, [(b, c)], refs)[0]["logit_gap"]["value"]
               for b, c in enumerate(ctrl))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    from cbnn_bench import run
    run._paths()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in (int(x) for x in args.seeds.split(",")):
        prog = None
        if not args.control_only:
            res = run.measure(args.workload, s, args.seconds, False, "cuda",
                              time.perf_counter())
            prog = res["checks"]["logit_gap"]["value"]
            queries = res["attempted"]
        ctrl = control_gap(args.workload, s)
        print(f"reading {args.workload} seed={s} program_gap={prog!r} "
              f"queries={queries if prog is not None else 0} "
              f"control_gap={ctrl!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
