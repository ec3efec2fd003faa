"""Resumable dry-run farm: every (arch x shape x mesh) cell as a subprocess.

Port of ``repro/launch/farm.py`` (``ARCH_ORDER``, ``SHAPE_ORDER``,
``cells``, ``run_farm``, ``main``).  Each cell runs in a fresh process
(``launch.dryrun`` joins a fake process group for the life of its
process, and a failed cell must not poison later ones).  Results land in
``<out>/<cell>.json``; a cell with an OK or SKIP result is not run again,
so the farm can be stopped and resumed freely.

  PYTHONPATH=src python -m repro_torch.launch.farm --out dryrun_results \\
      [--mesh both]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["ARCH_ORDER", "SHAPE_ORDER", "cells", "run_farm", "main"]

# cheap first: catch systematic faults before the 671B cells
ARCH_ORDER = [
    "tinyllama-1.1b", "mamba2-1.3b", "phi3-mini-3.8b", "minitron-4b",
    "hubert-xlarge", "pixtral-12b", "jamba-v0.1-52b", "deepseek-67b",
    "deepseek-v2-236b", "deepseek-v3-671b",
]
SHAPE_ORDER = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]


def cells(meshes):
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in meshes:
                yield arch, shape, mesh


def _src() -> str:
    """The directory holding ``repro_torch``, for the cells' path."""
    return str(Path(__file__).resolve().parents[2])


def run_farm(out: str, meshes, variant: str = "baseline",
             timeout_s: int = 3600) -> dict:
    """Run every cell not yet OK or SKIP; returns the counts."""
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = _src() + (os.pathsep + env["PYTHONPATH"]
                                  if env.get("PYTHONPATH") else "")
    done = ok = skip = fail = 0
    t_start = time.time()
    for arch, shape, mesh in cells(meshes):
        path = out_dir / f"{arch}__{shape}__{mesh}__{variant}.json"
        if path.exists():
            try:
                if json.loads(path.read_text()).get("status") in ("OK",
                                                                   "SKIP"):
                    done += 1
                    continue
            except json.JSONDecodeError:
                pass
        print(f"[farm +{time.time() - t_start:7.0f}s] {arch} {shape} "
              f"{mesh} ...", flush=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--variant", variant, "--out", str(out_dir)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout_s, env=env)
            if r.returncode != 0 and not path.exists():
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": mesh,
                     "variant": variant, "status": "FAIL",
                     "error": (r.stderr or r.stdout)[-3000:]}, indent=2))
        except subprocess.TimeoutExpired:
            path.write_text(json.dumps(
                {"arch": arch, "shape": shape, "mesh": mesh,
                 "variant": variant, "status": "FAIL",
                 "error": f"timeout after {timeout_s}s"}, indent=2))
        rec = json.loads(path.read_text())
        st = rec.get("status")
        ok += st == "OK"
        skip += st == "SKIP"
        fail += st == "FAIL"
        print(f"    -> {st} "
              + (f"step={rec.get('step_s')}s" if st == "OK"
                 else rec.get("reason", rec.get("error", ""))[:160]),
              flush=True)
    print(f"[farm] done: pre-existing={done} ok={ok} skip={skip} "
          f"fail={fail}", flush=True)
    return {"pre_existing": done, "ok": ok, "skip": skip, "fail": fail}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    return run_farm(args.out, meshes, args.variant, args.timeout)


if __name__ == "__main__":
    main()
