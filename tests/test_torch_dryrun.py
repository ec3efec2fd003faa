"""The port's dry run (``repro_torch.launch.dryrun`` through
``launch.farm``): one cell, TinyLlama-1.1B's train_4k on the (16, 16)
production mesh of 256 fake ranks, in a subprocess (the fake process
group lives for its process), as the reference's farm runs its cells;
and an off-table cell on a (2, 4) mesh of 8 fake ranks, tensor-parallel
against the same cell with every layer whole.

The farm finds every other cell of the mesh already recorded and runs
only this one (its resume path).  The record carries the reference's
keys; its argument bytes equal the local shard bytes this test computes
from the specs, exactly; the all-gathers move at least every sharded
parameter's shard; the step is tensor-parallel over "model" (every layer
splits: 2 of TinyLlama's 32 heads a rank) and its roofline is the
reference's ``roofline_terms(cfg, shape, None, collectives, 256)``: the
cell's work over every chip.  Every layer kind splits: a decode cell,
jamba's and deepseek-v3's train cells, minitron-4b's train and prefill
(24 heads over 16 ranks: 1 or 2 a rank) and an MLA decode cell on the
naive route run (a layer that does not split raises); ``--no-remat`` drops the recomputed
forward gathers: the stream's, and each layer's "data" gathers of its
parameters.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.launch import farm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.dryrun import parse_shape
from repro_torch.roofline.analyze import model_flops, roofline_terms

REPO = Path(__file__).resolve().parent.parent
CELL = ("tinyllama-1.1b", "train_4k", "single")


class _Mesh:
    shape, mesh_dim_names, ndim = (16, 16), ("data", "model"), 2

    def size(self, i):
        return self.shape[i]


class _Host8(_Mesh):
    shape = (2, 4)


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
    terms = roofline_terms(cfg, "train_4k", None, colls, 256)
    assert rec["roofline"] == json.loads(json.dumps(terms))
    assert rec["roofline"]["model_flops_global"] \
        == model_flops(cfg, "train_4k")
    assert rec["roofline"]["dominant"] == "compute"
    assert rec["memory"]["tracked_peak_bytes"] < 45 * 2 ** 30


def test_tensor_parallel_cell_against_replicated(tmp_path):
    """TinyLlama-1.1B at 8 x 256 on a (2, 4) mesh: the tensor-parallel
    step's roofline is the reference's over 8 chips, its compute a quarter
    of the replicated step's (the whole model on a rank's 4 sequences, as
    before tensor parallelism); its tracked peak sits below the whole
    model's float32 parameters and gradients, which a replicated step
    holds on every rank at once."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    arch, shape, mesh = "tinyllama-1.1b", "train:8:256", "host8"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--mesh", mesh,
                        "--out", str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    name = f"{arch}__{shape}__{mesh}__baseline.json".replace(":", "-")
    tp = json.loads((tmp_path / name).read_text())
    assert tp["status"] == "OK" and tp["n_chips"] == 8
    cfg = configs.get_config(arch)
    info = {"kind": "train", "global_batch": 8, "seq_len": 256}
    assert tp["roofline"] == json.loads(json.dumps(roofline_terms(
        cfg, info, None, tp["collectives"], 8)))
    replicated = roofline_terms(cfg, dict(info, global_batch=4), None,
                                tp["collectives"], 1)
    # a "model" row's 4 ranks split the products: a quarter of the FLOPs
    assert tp["roofline"]["compute_s"] < 0.3 * replicated["compute_s"]
    params, _ = steps.abstract_state(cfg, info)
    whole = sum(2 * 4 * p.numel() for p in params.parameters())
    assert tp["memory"]["tracked_peak_bytes"] < whole, (
        tp["memory"]["tracked_peak_bytes"], whole)


# (arch, shape, mesh, extra flags); NAIVE runs the decode step's MLA
# layers on the naive route (the dry run has no flag for it: the cell's
# process patches ``make_decode_step``)
NAIVE = "naive-mla"
SPLIT_CELLS = [
    ("tinyllama-1.1b", "decode:8:256", "host8", ""),
    ("jamba-v0.1-52b", "train:8:256", "host8", ""),
    ("deepseek-v3-671b", "train:8:256", "host8", ""),
    # 24 heads over 16 "model" ranks: 1 or 2 a rank
    ("minitron-4b", "train:16:256", "single", ""),
    ("minitron-4b", "prefill:16:256", "single", ""),
    ("deepseek-v2-236b", "decode:16:256", "single", NAIVE),
    ("tinyllama-1.1b", "train:8:256", "host8", "--no-remat"),
]
_NAIVE_RUN = ("import sys; from repro_torch.launch import dryrun, steps; "
              "f = steps.make_decode_step; steps.make_decode_step = "
              "lambda cfg, mla_absorbed=True, plan=None: f(cfg, False, "
              "plan); dryrun.main(sys.argv[1:])")


@pytest.fixture(scope="module")
def split_records(tmp_path_factory):
    """Each ``SPLIT_CELLS`` cell's record, the dry runs all started
    together (a subprocess each, an output directory each)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    runs = {}
    for i, cell in enumerate(SPLIT_CELLS):
        arch, shape, mesh, flags = cell
        out = tmp_path_factory.mktemp(f"cell{i}")
        run = ["-c", _NAIVE_RUN] if flags == NAIVE \
            else ["-m", "repro_torch.launch.dryrun"] + flags.split()
        cmd = [sys.executable] + run + ["--arch", arch, "--shape", shape,
                                        "--mesh", mesh, "--out", str(out)]
        runs[cell] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO)))
    recs = {}
    for (arch, shape, mesh, flags), (out, proc) in runs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        name = f"{arch}__{shape}__{mesh}__baseline.json".replace(":", "-")
        recs[arch, shape, mesh, flags] = json.loads((out / name).read_text())
    return recs


@pytest.mark.parametrize("cell", SPLIT_CELLS,
                         ids=[" ".join(c).strip() for c in SPLIT_CELLS])
def test_every_layer_kind_splits(split_records, cell):
    """The decode step and jamba's (Mamba-2, GQA, MLP, dense MoE) and
    deepseek-v3's (MLA, MLP, dense MoE, MTP) train steps run every layer
    tensor-parallel over "model"; so do minitron-4b's train and prefill
    steps (24 heads over 16 ranks: 1 or 2 a rank) and deepseek-v2's
    decode step on the naive MLA route: the step runs (a layer that does
    not split raises) and its roofline is the cell's over every chip."""
    rec = split_records[cell]
    assert rec["status"] == "OK", rec.get("error")
    arch, shape, mesh, _ = cell
    assert rec["roofline"] == json.loads(json.dumps(roofline_terms(
        configs.get_config(arch), parse_shape(shape)[1], None,
        rec["collectives"], rec["n_chips"])))


def test_no_remat_flag(split_records):
    """``--no-remat`` (the reference's flag) runs the cell with remat off:
    no layer is recomputed in the backward pass, so each layer's two
    forward all-gathers of the stream and its "data" gathers of its
    parameters (one a leaf split over "data": host8 has 2 data ranks)
    run once, not twice (TinyLlama 8 x 256 on host8, 22 layers;
    ``test_torch_tensor_parallel.py::test_collectives_per_layer`` counts
    the stream's a layer, ``test_torch_fsdp_layers.py`` the
    parameters')."""
    off = split_records["tinyllama-1.1b", "train:8:256", "host8",
                        "--no-remat"]
    assert off["status"] == "OK"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("from repro_torch.launch import dryrun; import json; "
            "print(json.dumps(dryrun.dryrun_cell('tinyllama-1.1b', "
            "'train:8:256', 'host8')['collectives']))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    remat = json.loads(r.stdout.strip().splitlines()[-1])
    cfg = configs.get_config("tinyllama-1.1b")
    params, _ = steps.abstract_state(cfg, "train_4k")
    specs = mesh_lib.param_specs(params, mesh_lib.Plan(_Host8()))
    split = sum("data" in specs[k] for k in specs
                if k.startswith("layers.0."))
    assert split == 7           # q, k, v, o and the MLP's three
    assert remat["all-gather"]["count"] \
        - off["collectives"]["all-gather"]["count"] == (2 + split) * 22
