"""Time the local backend's end-to-end figures of two checkouts of the
PyTorch/CUDA port in turns, on one GPU.

    python3 scripts/local_ab.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--nets MnistNet1,...] \
        [--queries N] [--no-lm]

Each turn runs one checkout in a process of its own, from its own
directory, with its own ``repro_torch`` and its own ``chip_smoke.py``
constants, and reads the two figures that ``chip_smoke.py`` reports for
the local backend:

* phase 3: q/s of every auto-routed path of ``PINNED`` (``QUERIES`` queries
  at ``BATCH`` after a warm-up; the ReLU nets on He-normal weights, as
  phase 3 serves them); ``--nets`` keeps the paths of those nets and
  ``--queries`` sets the timed queries a path;
* phase 11: the secure LM's decode tok/s at ``SLM``'s widths and
  ``SLM_BLOCKS`` blocks (prompt 8, gen 8, buckets 16 and 64, a warm-up and
  one timed generation: the same work for both checkouts, whatever their
  ``SLM_SERVE``); ``--no-lm`` skips it.

Prints one JSON line a turn and, last, the readings by checkout.  Compare
two checkouts only within one run: the card's clocks and the host move
between runs.
"""
import argparse
import json
import os
import subprocess
import sys

LM_SERVE = dict(prompt_len=8, gen=8, buckets=(16, 64), queries=1)

WORKER = r"""
import json, sys, time
sys.path[:0] = ["src", "."]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.core import linear
from repro_torch.kernels import build as kbuild
from repro_torch.launch.serve_secure import serve, serve_lm
from repro_torch.nn.bnn import INPUT_SHAPES, init_bnn

opts = json.loads(sys.argv[1])

torch.backends.cuda.matmul.allow_tf32 = False
kbuild.build_all()
out = {"qps": {}}
for key in cs.PINNED:
    net, weights, binary_linear, fused = key
    if binary_linear != "auto" or (opts["nets"]
                                   and net not in opts["nets"]):
        continue
    given = {}
    if net in cs.RELU_NETS:
        given = {"params": init_bnn(0, net, device="cuda"),
                 "x": np.random.default_rng(1).normal(
                     0, 0.3, (cs.BATCH,) + INPUT_SHAPES[net])
                 .astype(np.float32)}
    linear.set_fused_rounds(fused)
    try:
        st = serve(net, cs.BATCH, opts["queries"] or cs.QUERIES,
                   device="cuda", weights=weights,
                   binary_linear=binary_linear, **given)
    finally:
        linear.set_fused_rounds(True)
    out["qps"][f"{net} {weights} fused={fused}"] = st["query_per_s"]
if opts["lm"]:
    torch.cuda.empty_cache()
    st = serve_lm(**cs.SLM, blocks=cs.SLM_BLOCKS, **opts["lm_serve"],
                  device="cuda")
    out["lm_decode_tok_per_s"] = st["decode_tok_per_s"]
    out["lm_tok_per_s"] = st["tok_per_s"]
print("RESULT " + json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout of the port (twice or more)")
    ap.add_argument("--order", default=None,
                    help="comma-separated names (default: A,B,B,A)")
    ap.add_argument("--nets", default="",
                    help="comma-separated nets whose paths run (default: all)")
    ap.add_argument("--queries", type=int, default=0,
                    help="timed queries a path (default: the checkout's "
                         "QUERIES)")
    ap.add_argument("--lm", action=argparse.BooleanOptionalAction,
                    default=True, help="time the secure LM too")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a turn may take")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = (args.order.split(",") if args.order
             else [names[0], names[1], names[1], names[0]])
    opts = json.dumps({"nets": [n for n in args.nets.split(",") if n],
                       "queries": args.queries, "lm": args.lm,
                       "lm_serve": LM_SERVE})
    readings = {n: [] for n in names}
    for name in order:
        cwd = os.path.abspath(trees[name])
        env = dict(os.environ, PYTHONPATH=os.path.join(cwd, "src"))
        proc = subprocess.run(
            [sys.executable, "-c", WORKER, opts], cwd=cwd,
            env=env, capture_output=True, text=True, timeout=args.timeout)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or line is None:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            sys.exit(f"{name}: the turn failed (rc {proc.returncode})")
        res = json.loads(line[len("RESULT "):])
        readings[name].append(res)
        print(json.dumps({"turn": name, **res}), flush=True)
    print(json.dumps({"by_tree": readings}))


if __name__ == "__main__":
    main()
