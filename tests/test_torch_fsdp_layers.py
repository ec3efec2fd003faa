"""FSDP storage gathered one layer at a time
(``repro_torch.launch.tensor_parallel.gathered``), and GQA heads that the
"model" axis does not divide.

The reference keeps each parameter matrix split over "data" (FSDP
storage) and gathers it per layer inside its scanned, checkpointed layer
body (``repro/launch/mesh.py:5-6``, ``repro/nn/transformer.py:207-219``);
the port gathers a layer's "model" shards over "data" just before the
layer runs, again in its recomputation under remat, and its backward
reduce-scatters each gradient back to the storage shard.

* Parity, on gloo CPU ranks: one train step of the reduced deepseek-v3
  (MLA, MLP, dense MoE, MTP) and jamba (Mamba-2, GQA, MoE; gathered a
  sub-layer at a time) on (2, 1) and (2, 2) ("data", "model") meshes
  against the mesh-less port at ``test_torch_tensor_parallel.py``'s
  bounds (loss 2e-3, parameters rtol/atol 2e-4; the gradient norm
  2e-3 relative: see ``NORM_TOL``).  The mesh-less step is the mean of each data shard's loss: the
  MoE's capacity counts a call's tokens, so a data shard drops as its own
  call would.
* Gradient scale: after one backward pass on a (2, 1) and a (2, 2) mesh
  (and a (2, 2, 1) ("pod", "data", "model") one) each leaf's gradient
  equals the mesh-less one within ``GRAD_REL`` of its norm (1e-6 with one
  "model" rank, 5e-2 with two); a gradient summed over "data" twice
  reads 1.0 off (2x), one not summed 0.5.
* Collectives, counted on ``meta`` over a fake group of a (2, 1) mesh
  (only "data" moves there), one layer (one jamba period) more against
  the same model: one all-gather a leaf split over "data", its operand
  that leaf's storage shard (never more than one layer's); twice a train
  step under remat (the recomputation gathers again), once without remat
  and in prefill and decode; in train one reduce-scatter a split leaf
  (its gradient, the gathered shape, float32) and one all-reduce a leaf
  whole over "data" (a norm's).  A jamba period nests a checkpoint a
  sub-layer: its outer recomputation runs each sub-layer's inner
  checkpoint but the last, whose recomputation gathers again, so a
  sub-layer gathers 3 times but the last, twice.
* Peak: the dry run's tracked peak of TinyLlama-1.1B's 8 x 64 train
  step on 8 fake ranks as (4, 2) ("data", "model"), against the same cell
  gathering the whole model at once, which held every leaf's "model"
  shard and, when the backward pass returned, every gradient of it: its
  peak is at least the arguments plus twice the model shard.  Gathering a
  layer at a time must save at least (model shard - one layer) of that.
* Uneven heads: a reduced minitron with 6 heads, 2 kv heads and head
  width 8 (minitron-4b's 1.5 heads a rank and group 3) on (1, 4) and
  (2, 4): each rank runs heads [6j/4, 6(j+1)/4), 1 or 2; train and
  prefill against the mesh-less port (logits within 2^-7 of their scale)
  and against the reference's jitted steps under ``in_shardings`` on 8
  fake host devices in a subprocess (``test_torch_train.py``'s bounds
  for the step; the prefill no further from the reference's than the
  mesh-less port is, plus 2^-7 of the scale); and 9 heads over 2
  ranks with 3 kv heads, where a rank's heads do not fall in whole
  groups and each reads its own copy of its kv head.
"""
import collections
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_launch_ranks as tasks
from repro_torch.configs import get_config
from repro_torch.core.party_group import PartyGroup
from repro_torch.data import token_stream
from repro_torch.launch import steps
from repro_torch.nn import transformer as tfm
from repro_torch.nn.layers import trainable
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.weights import lm_flat, lm_params_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 2e-4
# the first step's gradient norm, relative: deepseek-v3 on (2, 2) reads
# 1.42e-3, bit for bit what the whole-model gather gave (the m = 2 row's
# bf16 cotangents summed over the ranks; test_torch_tensor_parallel.py's
# 1e-3 holds its m = 2 cases on one data shard)
LOSS_TOL, NORM_TOL = 2e-3, 2e-3
# a leaf's |g - ref| over |ref|: on one "model" rank the float32 sums over
# "data" are the mesh-less ones; on (2, 2) the row's bf16 cotangent sums
# read up to 1.53e-2 (the embedding; the whole-model gather read the
# same).  Summed twice over "data" a gradient reads 1.0, not summed 0.5
GRAD_REL = {1: 1e-6, 2: 5e-2}
LOGITS_TOL = 2 ** -7     # of the logits' scale
# test_torch_train.py's bounds against the reference
LOSS_REL, NORM_REL, MOVE_TOL, NOISE_RMS = 1e-3, 1e-2, 1e-6, 0.3
UNEVEN = dict(n_heads=6, n_kv_heads=2, head_dim=8)
UNEVEN_MESHES = [(1, 4), (2, 4)]


@pytest.fixture(scope="module")
def groups():
    with PartyGroup("cpu", timeout=60, deadline=240, ranks=2) as g2, \
            PartyGroup("cpu", timeout=60, deadline=240, ranks=4) as g4, \
            PartyGroup("cpu", timeout=60, deadline=240, ranks=8) as g8:
        yield {2: g2, 4: g4, 8: g8}


def _batch(cfg, b=4, s=32, seed=1):
    stream = token_stream(b, s, cfg.vocab, seed=seed)
    return {k: torch.as_tensor(v) for k, v in next(stream)[0].items()}


def _shard_mean(cfg, model, batch, n_data):
    """The mean over ``n_data`` data shards of each shard's loss, and its
    gradient with respect to every parameter (None where unused)."""
    b = batch["tokens"].shape[0] // n_data
    with trainable(model) as leaves:
        loss, grads = 0.0, [None] * len(leaves)
        for i in range(n_data):
            part = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            li = tfm.loss_fn(model, part, cfg) / n_data
            gi = torch.autograd.grad(li, leaves, allow_unused=True)
            loss = loss + float(li.detach())
            grads = [g if a is None else a if g is None else a + g
                     for a, g in zip(grads, gi)]
    return loss, dict(zip(dict(model.named_parameters()), grads))


PARITY = [("deepseek-v3-671b", (2, 1)), ("deepseek-v3-671b", (2, 2)),
          ("jamba-v0.1-52b", (2, 1)), ("jamba-v0.1-52b", (2, 2))]


@pytest.mark.parametrize("arch,shape", PARITY,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in PARITY])
def test_train_step_matches_mesh_less(groups, arch, shape):
    """One train step through per-layer gathers against the mesh-less
    step of the same data shards."""
    cfg = get_config(arch).reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch, opt_cfg = _batch(cfg), OptConfig()
    whole, ((loss, norm),), _ = groups[shape[0] * shape[1]].run(
        tasks.tp_train, (cfg, shape, sd, [batch], opt_cfg))[0]
    w_loss, grads = _shard_mean(cfg, model, batch, shape[0])
    named = dict(model.named_parameters())
    _, _, w_norm = adamw_update(named, grads, adamw_init(named, opt_cfg),
                                opt_cfg)
    assert abs(loss - w_loss) < LOSS_TOL, (loss, w_loss)
    assert abs(norm - float(w_norm)) <= NORM_TOL * float(w_norm)
    for k, v in named.items():
        np.testing.assert_allclose(whole[k].numpy(), v.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# ("data", "model") meshes, and a ("pod", "data", "model") one: the
# parameters whole over "pod", each gradient reduce-scattered over "data"
# and then all-reduced over "pod"
GRAD_CASES = [(a, s) for s in ((2, 1), (2, 2))
              for a in ("tinyllama-1.1b", "deepseek-v3-671b")] \
    + [("tinyllama-1.1b", (2, 2, 1))]


@pytest.mark.parametrize("arch,shape", GRAD_CASES,
                         ids=[f"{a}-{'x'.join(map(str, s))}"
                              for a, s in GRAD_CASES])
def test_gradients_summed_once_over_data(groups, arch, shape):
    """Each leaf's gradient of a mesh's backward pass (the layers'
    reduce-scattered by their gathers' backward) against the mesh-less
    gradient of the same data shards."""
    cfg = get_config(arch).reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(cfg)
    n = int(np.prod(shape))
    _, got = groups[n].run(tasks.tp_grads, (cfg, shape, sd, batch))[0]
    _, want = _shard_mean(cfg, model, batch, n // shape[-1])
    assert got.keys() == want.keys()
    worst = {}
    for k, g in want.items():
        if g is None:
            assert got[k] is None, k
            continue
        worst[k] = float((got[k] - g).norm() / g.norm())
    k = max(worst, key=worst.get)
    assert worst[k] <= GRAD_REL[shape[-1]], (k, worst[k])


# arch -> (layer counts (one layer, one jamba period, more), layer prefix)
COUNT_ARCHS = {"tinyllama-1.1b": ((1, 2), "layers.1."),
               "deepseek-v3-671b": ((2, 3), "layers.2."),
               "jamba-v0.1-52b": ((4, 8), "layers.1.")}
COUNT_RUNS = [("train", True), ("train", False), ("prefill", True),
              ("decode", True)]


@pytest.fixture(scope="module")
def step_calls():
    """Each ``COUNT_ARCHS`` arch's collectives a run and layer count on a
    (2, 1) mesh of ``meta`` tensors, the processes started together."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    procs = {}
    for arch, (counts, _) in COUNT_ARCHS.items():
        code = ("import torch_launch_ranks as t; t.count_step_calls("
                f"{arch!r}, {counts}, (2, 1), {COUNT_RUNS})")
        procs[arch] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    out = {}
    for arch, proc in procs.items():
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0, se[-3000:]
        out[arch] = json.loads(so.strip().splitlines()[-1])
    return out


def _added(rec, run, counts):
    """The collectives the larger layer count adds (a multiset)."""
    one, two = (collections.Counter(
        (k, tuple(s), b) for k, s, b in rec[f"{run} {n}"]) for n in counts)
    assert not one - two, one - two
    return two - one


def _storage_op(shape, dim):
    """A leaf's operand as c10d takes it: the gathered (or scattered) dim
    first."""
    shape = list(shape)
    return tuple([shape[dim]] + shape[:dim] + shape[dim + 1:])


@pytest.mark.parametrize("arch,run", [
    (a, r) for a in COUNT_ARCHS for r in COUNT_RUNS],
    ids=[f"{a}-{k}{'' if m else '-no-remat'}" for a in COUNT_ARCHS
         for k, m in COUNT_RUNS])
def test_data_gathers_per_layer(step_calls, arch, run):
    counts, prefix = COUNT_ARCHS[arch]
    rec = step_calls[arch]
    kind, remat = run
    added = _added(rec, f"{kind} {remat}", counts)
    leaves = {k: v for k, v in rec[f"leaves {counts[1]}"].items()
              if k.startswith(prefix)}
    split = {k: (s, d) for k, (s, d) in leaves.items() if d is not None}
    whole = {k: s for k, (s, d) in leaves.items() if d is None}
    assert split and whole

    def times(k):
        if kind != "train" or not remat:
            return 1
        if arch.startswith("jamba"):     # nested: sub-layers but the last
            return 2 if k.startswith(prefix + "sub3.") else 3
        return 2
    want = collections.Counter()
    for k, (s, d) in split.items():       # each the leaf's storage shard
        want["all-gather", _storage_op(s, d), 4 * int(np.prod(s))] \
            += times(k)
    if kind == "train":                   # the gathers' backward
        for k, (s, d) in split.items():
            g = list(s)
            g[d] *= 2                     # the gathered leaf's gradient
            want["reduce-scatter", _storage_op(g, d),
                 4 * int(np.prod(g))] += 1
        for k, s in whole.items():
            want["all-reduce", tuple(s), 4 * int(np.prod(s))] += 1
    assert added == want, (added - want, want - added)


PEAK_RUN = r"""
import json, sys
from repro_torch.launch import dryrun
dryrun.MESHES["d4"] = ((4, 2), ("data", "model"))
rec = dryrun.dryrun_cell("tinyllama-1.1b", "train:8:64", "d4")
print(json.dumps(rec["memory"]))
"""


def test_peak_below_whole_model_gather():
    """TinyLlama-1.1B's 8 x 64 train step on 8 fake ranks, (4, 2)
    ("data", "model"): a rank's tracked peak is at least (model shard -
    one layer) below the least peak of a step that gathers the whole
    model at once (the arguments, every leaf's "model" shard and every
    gradient of it), reckoned from the shapes."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", PEAK_RUN],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    mem = json.loads(r.stdout.strip().splitlines()[-1])
    cfg = get_config("tinyllama-1.1b")
    params, _ = steps.abstract_state(cfg, "train_4k")
    # the "model" axis (2 ranks) splits every matrix; norms stay whole
    shard = {k: 4 * p.numel() // (2 if p.ndim > 1 else 1)
             for k, p in params.named_parameters()}
    model_shard = sum(shard.values())
    layer = max(sum(v for k, v in shard.items()
                    if k.startswith(f"layers.{i}."))
                for i in range(cfg.n_layers))
    whole_gather = mem["argument_bytes"] + 2 * model_shard
    assert mem["tracked_peak_bytes"] \
        <= whole_gather - (model_shard - layer), (mem, model_shard, layer)


UNEVEN_REF = r"""
import dataclasses
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle
import sys
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.launch import mesh as mesh_lib
from repro.launch import steps
from repro.launch.context import use_plan
from repro.nn import transformer as tfm
from repro.optim import OptConfig, adamw_init

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
cfg = dataclasses.replace(get_config("minitron-4b").reduced(), **job["heads"])
batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
prompt = {"tokens": batch["tokens"]}
params = tfm.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw_init(params)
tree = lambda t: jax.tree.map(np.asarray, t)
out = {"params": tree(params)}
for shape in job["meshes"]:
    mesh = mesh_lib.make_mesh(tuple(shape), ("data", "model"))
    plan = mesh_lib.Plan(mesh)
    sh = lambda t: mesh_lib.to_shardings(t, plan)
    ps = mesh_lib.param_specs(params, plan)
    os_ = mesh_lib.opt_specs(opt, ps)
    with mesh, use_plan(plan):
        step = jax.jit(steps.make_train_step(cfg, OptConfig(warmup_steps=2)),
                       in_shardings=(sh(ps), sh(os_),
                                     sh(mesh_lib.batch_specs(batch, plan))),
                       out_shardings=(sh(ps), sh(os_), None))
        new, o2, m = step(params, opt, batch)
        pre = jax.jit(steps.make_prefill_step(cfg), in_shardings=(
            sh(ps), sh(mesh_lib.batch_specs(prompt, plan))))
        logits = pre(params, prompt)
    out[tuple(shape)] = {"new": tree(new), "m": tree(o2["m"]),
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "prefill": np.asarray(logits, np.float32)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


def _uneven_cfg():
    return dataclasses.replace(get_config("minitron-4b").reduced(), **UNEVEN)


@pytest.fixture(scope="module")
def uneven_reference(tmp_path_factory):
    """The reference's sharded train and prefill steps of the uneven
    minitron on each ``UNEVEN_MESHES`` mesh (8 fake host devices), from
    its own weights: started at once, read when a test needs it."""
    cfg = _uneven_cfg()
    d = tmp_path_factory.mktemp("uneven")
    batch = {k: v.numpy() for k, v in _batch(cfg, b=8).items()}
    with open(d / "job.pkl", "wb") as f:
        pickle.dump({"heads": UNEVEN, "batch": batch,
                     "meshes": UNEVEN_MESHES}, f)
    (d / "ref.py").write_text(UNEVEN_REF)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(d / "ref.py"), str(d / "job.pkl"),
         str(d / "out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(REPO))

    def read():
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, \
            f"stdout:\n{so[-2000:]}\nstderr:\n{se[-3000:]}"
        with open(d / "out.pkl", "rb") as f:
            return pickle.load(f), {k: torch.as_tensor(v)
                                    for k, v in batch.items()}
    cache = []
    yield lambda: cache[0] if cache else cache.append(read()) or cache[0]
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _heads_of(rank, shape):
    """The q heads a rank of a ("data", "model") mesh of ``shape`` runs:
    [jH/m, (j+1)H/m) of its "model" index j."""
    j, m, h = rank % shape[1], shape[1], UNEVEN["n_heads"]
    return (j + 1) * h // m - j * h // m


@pytest.mark.parametrize("shape", UNEVEN_MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in UNEVEN_MESHES])
def test_uneven_heads_match_mesh_less(groups, uneven_reference, shape):
    """1 or 2 of 6 heads a rank: the train and prefill steps against the
    mesh-less port (the reference's process, started by its fixture,
    compiles meanwhile)."""
    cfg = _uneven_cfg()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch, opt_cfg = _batch(cfg, b=8), OptConfig()
    group = groups[shape[0] * shape[1]]
    prompt = {"tokens": batch["tokens"]}
    with torch.no_grad():
        want = steps.make_prefill_step(cfg)(model, prompt).float()
    scale = float(want.abs().max())
    for r, (logits, first, seen) in enumerate(group.run(
            tasks.tp_prefill, (cfg, shape, sd, prompt))):
        ref = want[first:first + logits.shape[0]]
        assert float((logits.float() - ref).abs().max()) \
            <= LOGITS_TOL * scale
        assert seen["q_heads"] == [_heads_of(r, shape)]
    whole, ((loss, norm),), seen = group.run(
        tasks.tp_train, (cfg, shape, sd, [batch], opt_cfg))[0]
    assert seen["q_heads"] == [_heads_of(0, shape)]
    w_loss, grads = _shard_mean(cfg, model, batch, shape[0])
    named = dict(model.named_parameters())
    _, _, w_norm = adamw_update(named, grads, adamw_init(named, opt_cfg),
                                opt_cfg)
    assert abs(loss - w_loss) < LOSS_TOL, (loss, w_loss)
    assert abs(norm - float(w_norm)) <= NORM_TOL * float(w_norm)
    for k, v in named.items():
        np.testing.assert_allclose(whole[k].numpy(), v.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_uneven_heads_read_their_own_kv_heads(groups):
    """9 heads over 2 ranks with 3 kv heads (group 3): rank 0 runs heads
    0-3 (kv heads 0, 0, 0, 1), rank 1 heads 4-8 (1, 1, 2, 2, 2), neither
    in whole groups, so each local q head reads its own copy of its kv
    head; the prefill logits against the mesh-less port."""
    cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                              n_heads=9, n_kv_heads=3, head_dim=8)
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    prompt = {"tokens": _batch(cfg)["tokens"]}
    with torch.no_grad():
        want = steps.make_prefill_step(cfg)(model, prompt).float()
    scale = float(want.abs().max())
    outs = groups[2].run(tasks.tp_prefill, (cfg, (1, 2), sd, prompt))
    for (logits, _, seen), heads in zip(outs, (4, 5)):
        assert float((logits.float() - want).abs().max()) \
            <= LOGITS_TOL * scale
        assert seen["q_heads"] == seen["kv_heads"] == [heads]


@pytest.mark.parametrize("shape", UNEVEN_MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in UNEVEN_MESHES])
def test_uneven_heads_match_reference_sharded_steps(groups, uneven_reference,
                                                    shape):
    """The port's uneven split against the reference's GSPMD split of the
    same storage (1.5 heads a rank): one train step from the reference's
    weights at ``test_torch_train.py``'s bounds, and the prefill logits
    no further from the reference's than the mesh-less port's are, plus
    2^-7 of their scale."""
    ref, batch = uneven_reference()
    cfg = _uneven_cfg()
    model = lm_params_from_numpy(ref["params"], cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_cfg = OptConfig(warmup_steps=2)
    group = groups[shape[0] * shape[1]]
    cell = ref[tuple(shape)]
    prompt = {"tokens": batch["tokens"]}
    want = torch.as_tensor(cell["prefill"])
    with torch.no_grad():
        port = steps.make_prefill_step(cfg)(model, prompt).float()
    scale = float(want.abs().max())
    gap = float((port - want).abs().max())
    for logits, first, _ in group.run(tasks.tp_prefill,
                                      (cfg, shape, sd, prompt)):
        err = float((logits.float() - want[first:first + logits.shape[0]])
                    .abs().max())
        assert err <= gap + LOGITS_TOL * scale, (err, gap, scale)
    whole, ((loss, norm),), _ = group.run(
        tasks.tp_train, (cfg, shape, sd, [batch], opt_cfg))[0]
    jloss, jnorm = cell["loss"], cell["grad_norm"]
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    assert abs(norm - jnorm) <= NORM_REL * jnorm
    clip = min(1.0, 1.0 / (jnorm + 1e-9))
    jgrad = {k: v / (0.1 * clip)
             for k, v in lm_flat(cell["m"], cfg).items()}
    old, new = lm_flat(ref["params"], cfg), lm_flat(cell["new"], cfg)
    lr = opt_cfg.lr
    for k, p in whole.items():
        dd = np.abs((p.numpy() - old[k]) - (new[k] - old[k]))
        g = np.abs(jgrad[k])
        firm = g > NOISE_RMS * np.sqrt(np.mean(g * g))
        assert firm.any() and dd[firm].max() <= MOVE_TOL, k
        assert dd.max() <= 2 * lr + 1e-6, k


# (arch, the reduced config's changes, the error) of a layer that "model"
# (2 ranks) does not divide
UNSPLIT = {
    "mlp": ("tinyllama-1.1b", dict(d_ff=255), "the MLP's 255 columns"),
    "moe": ("deepseek-v3-671b", dict(n_experts=3), "3 experts"),
    "mla": ("deepseek-v2-236b", dict(n_heads=3), "MLA's 3 heads"),
    "mamba2": ("mamba2-1.3b", dict(mamba_head_dim=256),
               "Mamba-2's 1 heads"),
}


@pytest.mark.parametrize("kind", list(UNSPLIT))
def test_layer_that_does_not_split_raises(groups, kind):
    """A layer whose FFN columns, experts, MLA or Mamba-2 heads the
    "model" axis does not divide raises on every rank of a (1, 2) mesh:
    no layer runs whole."""
    arch, changes, msg = UNSPLIT[kind]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    sd = tfm.init_params(cfg, 0, "cpu").state_dict()
    prompt = {"tokens": _batch(cfg, b=2, s=8)["tokens"]}
    outs = groups[2].run(tasks.tp_unsplit, (cfg, (1, 2), sd, prompt))
    for err in outs:
        assert err is not None and msg in err, err
