"""The port's dry run (``repro_torch.launch.dryrun`` through
``launch.farm``): one cell, TinyLlama-1.1B's train_4k on the (16, 16)
production mesh of 256 fake ranks, in a subprocess (the fake process
group lives for its process), as the reference's farm runs its cells.

The farm finds every other cell of the mesh already recorded and runs
only this one (its resume path).  The record carries the reference's
keys; its argument bytes equal the local shard bytes this test computes
from the specs, exactly; the all-gathers move at least every sharded
parameter's shard; the roofline is the step a rank runs (no tensor
parallelism: the whole model on its batch shard of 16 x 4096 tokens),
``roofline_terms`` of that shape on one card and the record's own
collectives, beside the cell's 16 data shards and its model FLOPs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch import configs
from repro_torch.launch import farm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.roofline.analyze import model_flops, roofline_terms

REPO = Path(__file__).resolve().parent.parent
CELL = ("tinyllama-1.1b", "train_4k", "single")


class _Mesh:
    shape, mesh_dim_names, ndim = (16, 16), ("data", "model"), 2

    def size(self, i):
        return self.shape[i]


def _local_numel(shape, spec, sizes):
    n = 1
    for i, d in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                d //= sizes[a]
        n *= d
    return n


def test_farm_runs_the_missing_cell(tmp_path):
    out = tmp_path / "res"
    out.mkdir()
    for arch, shape, mesh in farm.cells(["single"]):
        if (arch, shape, mesh) != CELL:
            (out / f"{arch}__{shape}__{mesh}__baseline.json").write_text(
                json.dumps({"status": "SKIP", "reason": "recorded"}))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.farm",
                        "--out", str(out), "--mesh", "single",
                        "--timeout", "300"], capture_output=True, text=True,
                       timeout=400, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "pre-existing=39 ok=1 skip=0 fail=0" in r.stdout, r.stdout
    rec = json.loads((out / "tinyllama-1.1b__train_4k__single__baseline"
                           ".json").read_text())
    assert rec["status"] == "OK" and rec["n_chips"] == 256
    assert {"memory", "collectives", "roofline", "step_s"} <= set(rec)

    cfg = configs.get_config("tinyllama-1.1b")
    plan = mesh_lib.Plan(_Mesh())
    sizes = {"data": 16, "model": 16}
    params, _ = steps.abstract_state(cfg, "train_4k")
    specs = mesh_lib.param_specs(params, plan)
    named = dict(params.named_parameters())
    shard_numel = {k: _local_numel(p.shape, specs[k], sizes)
                   for k, p in named.items()}
    param_bytes = 4 * sum(shard_numel.values())
    # params + two float32 moments + the int32 step + tokens and labels
    # (256 x 4096 int32 over 16 data ranks each)
    want = 3 * param_bytes + 4 + 2 * 4 * (256 // 16) * 4096
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes_est"] >= want
    colls = rec["collectives"]
    sharded = [k for k in named if any(specs[k])]
    assert colls["all-gather"]["count"] >= len(sharded)
    assert colls["all-gather"]["bytes"] >= 4 * sum(shard_numel[k]
                                                   for k in sharded)
    assert colls["reduce-scatter"]["count"] >= len(sharded)
    assert colls["total_bytes"] == sum(
        v["bytes"] for k, v in colls.items() if k != "total_bytes")
    rank_shape = dict(configs.SHAPES["train_4k"], global_batch=256 // 16)
    terms = roofline_terms(cfg, rank_shape, None, colls, 1)
    terms.update(data_shards=16,
                 model_flops_global=model_flops(cfg, "train_4k"))
    assert rec["roofline"] == json.loads(json.dumps(terms))
    assert rec["roofline"]["dominant"] == "compute"
