"""The decode step split over "model" (``launch.steps.make_decode_step``
with a plan), and the softmax that combines a sequence split over it.

Gloo CPU ranks (one ``PartyGroup`` of 2 and one of 4 for the module) run
the port's tensor-parallel decode step on (1, 2), (2, 2) and (1, 4)
("data", "model") meshes of the reduced configs, from the weights and a
seeded cache (B 4, S 16, every leaf N(0, 0.25)) that the mesh-less port
starts from, four steps at positions 2, 7, 8 and 15: on rank 0's slice
(every other rank's slice all masked at m = 4), across the boundary of
rank 0's (7 | 8 at m = 2, 4 | 8 ranks 1 and 2 at m = 4) and on the last
rank's slice:

* against the mesh-less port: each step's logits within 2^-7 of their
  scale (one bf16 ulp: the row products' float32 partial sums round
  some bf16 values the other way, as the train step's do); each rank's
  cache shards against the mesh-less cache's same slice, the positions
  written (and Mamba-2's state and conv window, rewritten every step)
  within one bf16 ulp of the leaf's scale, every other position bit for
  bit.  The MoE archs replay the mesh-less run's expert choices
  (``moe.replay_routing``): top-k routing is discontinuous, and an ulp
  can flip a choice (``test_torch_zoo.py`` does the same).
* the widths a rank computes: S/m cache positions, H/m Mamba-2 heads
  in the state and d_inner/m gate columns, d_ff/m FFN columns, E/m
  experts; MLA's naive route runs whole.
* against the reference: its jitted decode step (and its MLA / Mamba-2
  prefill step) under ``in_shardings`` from ``param_specs`` /
  ``cache_specs`` on 4 fake host devices in a subprocess (GSPMD's
  sharded compute), from its own weights and the same cache: the split
  port's logits no further from the reference's than the mesh-less
  port's are, plus 2^-7 of their scale (the packages' own bf16 gap, 1.0-
  2.8% of the scale here, is ``test_torch_lm.py``'s 3% bound).  The MoE
  arch runs on (1, 4): the reference computes capacity over the global
  batch.
* the collectives a decode layer adds, counted on ``meta`` over a fake
  group: every operand a token's (B x d, B x H x hd, B x h x r, the
  token's projection columns), none a weight's or the cache's.
* a rank whose slice is all masked contributes exact zeros: the combine
  equals the softmax over the other ranks' slices, with no NaN.
"""
import copy
import json
import math
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
from repro_torch.launch import steps as steps_lib
from repro_torch.nn import moe
from repro_torch.nn import transformer as tfm
from repro_torch.weights import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
B, S = 4, 16
POSITIONS = (2, 7, 8, 15)
LOGITS_TOL = 2 ** -7           # of the logits' scale
REF_GAP_TOL = 0.03             # test_torch_lm.py's LOGIT_TOL
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")

# (arch, mesh, naive MLA, widths a rank computes in decode)
CASES = [
    ("tinyllama-1.1b", (1, 2), False, {"ffn": [128]}),
    ("tinyllama-1.1b", (2, 2), False, {"ffn": [128]}),
    ("tinyllama-1.1b", (1, 4), False, {"ffn": [64]}),
    ("mamba2-1.3b", (1, 2), False, {"gate": [128]}),
    ("mamba2-1.3b", (2, 2), False, {"gate": [128]}),
    ("mamba2-1.3b", (1, 4), False, {"gate": [64]}),
    ("jamba-v0.1-52b", (1, 2), False, {"ffn": [128], "gate": [128],
                                       "experts": [4]}),
    ("deepseek-v2-236b", (1, 2), False, {"ffn": [64, 128], "experts": [4]}),
    ("deepseek-v2-236b", (1, 2), True, {"ffn": [64, 128], "experts": [4]}),
    ("deepseek-v2-236b", (1, 4), True, {"ffn": [32, 64], "experts": [2]}),
    ("deepseek-v3-671b", (1, 4), False, {"ffn": [16, 64], "experts": [2]}),
    ("deepseek-v3-671b", (1, 2), True, {"ffn": [32, 128], "experts": [4]}),
    ("deepseek-v3-671b", (1, 4), True, {"ffn": [16, 64], "experts": [2]}),
]


@pytest.fixture(scope="module")
def groups():
    with PartyGroup("cpu", timeout=60, deadline=240, ranks=2) as g2, \
            PartyGroup("cpu", timeout=60, deadline=240, ranks=4) as g4:
        yield {2: g2, 4: g4}


def _cache(cfg) -> list:
    """A seeded cache: every leaf N(0, 0.25), in its dtype."""
    cache = tfm.init_cache(cfg, B, S, "cpu")
    rng = np.random.default_rng(3)

    def fill(tree):
        for v in tree.values():
            if isinstance(v, dict):
                fill(v)
            else:
                v.copy_(torch.as_tensor(rng.normal(0, 0.5, v.shape)))
    for c in cache:
        fill(c)
    return cache


def _steps(cfg) -> list:
    rng = np.random.default_rng(4)
    return [(torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)),
                             dtype=torch.int32), p) for p in POSITIONS]


def _mesh_less(cfg, model, cache, steps, naive):
    """The mesh-less decode steps: (each step's logits, the final cache,
    the MoE calls' expert choices)."""
    out = []
    with torch.no_grad(), moe.record_routing() as calls:
        for tokens, pos in steps:
            logits, cache = tfm.decode_step(model, cache, tokens, pos, cfg,
                                            mla_absorbed=not naive)
            out.append(logits.float())
    return out, cache, [c[0] for c in calls]


def _ulp(t: torch.Tensor) -> float:
    """One bf16 ulp of ``t``'s scale."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def _check_shard(name, got, want, first, j, m, written):
    """A rank's cache leaf against the mesh-less leaf's same slice."""
    want = want[first:first + got.shape[0]]
    if name in SEQ_LEAVES:
        s = want.shape[1] // m
        want = want[:, j * s:(j + 1) * s]
        assert got.shape[1] == s, (name, got.shape)       # S/m positions
        mine = [p - j * s for p in written if j * s <= p < (j + 1) * s]
        rest = [i for i in range(s) if i not in mine]
        assert torch.equal(got[:, rest], want[:, rest]), name
        if mine:
            err = (got[:, mine].float() - want[:, mine].float()).abs().max()
            assert float(err) <= _ulp(want), (name, float(err))
        return
    dim = 1 if name == "state" else 2        # heads / conv channels
    n = want.shape[dim] // m
    assert got.shape[dim] == n, (name, got.shape)
    want = want.narrow(dim, j * n, n)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ulp(want), (name, err, _ulp(want))


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize(
    "arch,shape,naive,widths", CASES,
    ids=[f"{a}-{s[0]}x{s[1]}{'-naive' if n else ''}"
         for a, s, n, _ in CASES])
def test_decode_matches_mesh_less(groups, arch, shape, naive, widths):
    cfg = get_config(arch).reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    cache, steps = _cache(cfg), _steps(cfg)
    outs = groups[shape[0] * shape[1]].run(tasks.tp_decode, (
        cfg, shape, sd, copy.deepcopy(cache), steps, not naive,
        None if not cfg.moe else _mesh_less(
            cfg, model, copy.deepcopy(cache), steps, naive)[2]))
    want, want_cache, _ = _mesh_less(cfg, model, cache, steps, naive)
    m = shape[1]
    for o in outs:
        for got, ref in zip(o["logits"], want):
            ref = ref[o["first"]:o["first"] + got.shape[0]]
            err = float((got - ref).abs().max())
            assert err <= LOGITS_TOL * float(ref.abs().max()), err
        for layer, ref in zip(o["cache"], want_cache):
            refs = dict(_walk(ref))
            for path, got in _walk(layer):
                _check_shard(path[-1], got, refs[path], o["first"], o["j"],
                             m, POSITIONS)
        full = {k: [] for k in ("ffn", "gate", "experts")}
        assert {k: o["widths"][k] for k in full} == dict(full, **widths)
        # MLA's naive decode splits too: no head runs ``_sdpa`` on the
        # whole cache (every head is scored on the rank's S/m positions)
        assert o["widths"]["mla_heads"] == []


def test_all_masked_slice_contributes_zeros(groups):
    """The combine of a sequence whose last ranks' slices are all masked
    (-inf, or the port's finite NEG_INF) equals the softmax over the
    unmasked positions, finite, on 2 and 4 ranks."""
    rng = np.random.default_rng(5)
    values = torch.as_tensor(rng.normal(0, 1, (16, 8)), dtype=torch.float32)
    for m, masked in ((2, 8), (4, 4)):
        for fill in (float("-inf"), -1e9):
            scores = torch.as_tensor(rng.normal(0, 3, (3, 16)),
                                     dtype=torch.float32)
            scores[:, masked:] = fill
            want = torch.softmax(scores, -1) @ values
            for got in groups[m].run(tasks.tp_softmax, (scores, values)):
                assert torch.isfinite(got).all()
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _decode_calls(arch, shape, absorbed=True):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    n = 2 if arch == "deepseek-v2-236b" else 1   # + an MLA / MoE layer
    code = ("import torch_launch_ranks as t; t.count_decode_collectives("
            f"{arch!r}, ({n}, {n + 1}), {shape}, 2, 64, {absorbed})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    one, two = got[str(n)], got[str(n + 1)]
    # the embedding's all-reduce, the layers, the logits' gather
    assert two[:len(one) - 1] == one[:-1] and two[-1] == one[-1]
    return [(k, tuple(s), b) for k, s, b in two[len(one) - 1:-1]]


# a layer's collectives on a (1, 2) mesh (B 2, m 2; one data shard, so no
# parameter's "data" dims are gathered), in order: (kind, operand shape as
# c10d takes it: a gather's dim moved first, bytes)
DECODE_CALLS = {
    # GQA: the token's q, k, v columns (2 x 1 x (4 + 2 + 2) x 32 / 2 bf16),
    # the softmax's max (B x H) and sums (B x H x (hd + 1)), wo's and the
    # MLP's float32 row partials (B x d)
    "tinyllama-1.1b": [
        ("all-gather", (128, 2, 1), 512),
        ("all-reduce", (2, 2, 2, 1, 1), 32),
        ("all-reduce", (2, 2, 2, 1, 33), 1056),
        ("all-reduce", (2, 1, 128), 1024),
        ("all-reduce", (2, 1, 128), 1024)],
    # Mamba-2: the token's projection columns (584 / 2 bf16), the conv's
    # output channels (320 / 2 bf16), the gated norm's squares (256 / 2
    # float32), w_out's row partials
    "mamba2-1.3b": [
        ("all-gather", (292, 2, 1), 1168),
        ("all-gather", (160, 2, 1), 640),
        ("all-gather", (128, 2, 1), 1024),
        ("all-reduce", (2, 1, 128), 1024)],
    # MLA absorbed + MoE: the latents' columns ((48 + 32 + 16) / 2 bf16),
    # the absorbed queries of the rank's 2 heads (r + rd wide), the
    # softmax's max and sums (B x h x (r + 1)), wo's partials; the router
    # logits' columns (B x E / m float32), the experts' and the shared
    # MLP's partials
    "deepseek-v2-236b": [
        ("all-gather", (48, 2, 1), 192),
        ("all-gather", (2, 2, 1, 48), 384),
        ("all-reduce", (2, 4, 1, 1), 32),
        ("all-reduce", (2, 4, 1, 33), 1056),
        ("all-reduce", (2, 1, 128), 1024),
        ("all-gather", (4, 2), 32),
        ("all-reduce", (2, 1, 128), 1024),
        ("all-reduce", (2, 1, 128), 1024)],
    # MLA naive + MoE: the latents' columns, the token's q gathered over
    # heads ((hd + rd) wide, bf16), then the one weight the route gathers:
    # w_uk and w_uv over "model" in bf16 (r x h·hd / m each, token-free),
    # to expand the rank's S/m latent positions; the softmax's max and
    # sums (B x h x (hd + 1): every head a kv head), wo's partials; the
    # MoE as above
    "deepseek-v2-236b-naive": [
        ("all-gather", (48, 2, 1), 192),
        ("all-gather", (2, 2, 1, 48), 384),
        ("all-gather", (64, 32), 4096),
        ("all-gather", (64, 32), 4096),
        ("all-reduce", (2, 4, 1, 1, 1), 32),
        ("all-reduce", (2, 4, 1, 1, 33), 1056),
        ("all-reduce", (2, 1, 128), 1024),
        ("all-gather", (4, 2), 32),
        ("all-reduce", (2, 1, 128), 1024),
        ("all-reduce", (2, 1, 128), 1024)],
}
# the naive route's weight gathers (w_uk, w_uv: r x h·hd / m bf16 each)
NAIVE_WEIGHT_GATHERS = [("all-gather", (64, 32), 4096)] * 2


@pytest.mark.parametrize("arch", sorted(DECODE_CALLS))
def test_decode_collectives_per_layer(arch):
    """One more layer adds exactly the design's collectives, each a
    token's operand but the naive MLA route's two weight gathers
    (``NAIVE_WEIGHT_GATHERS``): a (1, 2) mesh's decode step on ``meta``
    at B 2 over a 64-position cache."""
    naive = arch.endswith("-naive")
    calls = _decode_calls(arch.removesuffix("-naive"), (1, 2), not naive)
    assert calls == [(k, s, b) for k, s, b in DECODE_CALLS[arch]]
    weights = [c for c in calls if c[2] >= 4096]
    assert weights == (NAIVE_WEIGHT_GATHERS if naive else [])


REF_SCRIPT = r"""
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

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}
for arch, shape in job["cells"]:
    cfg = get_config(arch).reduced()
    data = job["data"][arch]
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    like = tfm.init_cache(cfg, data["batch"], data["seq"])
    cache = jax.tree.map(lambda a, l: jnp.asarray(a, l.dtype),
                         data["cache"], like)
    mesh = mesh_lib.make_mesh(tuple(shape), ("data", "model"))
    plan = mesh_lib.Plan(mesh)
    sh = lambda t: mesh_lib.to_shardings(t, plan)
    ps = sh(mesh_lib.param_specs(params, plan))
    rec = {"params": jax.tree.map(np.asarray, params), "decode": []}
    with mesh, use_plan(plan):
        b0 = {"tokens": jnp.asarray(data["steps"][0][0]), "pos": jnp.int32(0)}
        dec = jax.jit(steps.make_decode_step(cfg), in_shardings=(
            ps, sh(mesh_lib.cache_specs(cache, plan)),
            sh(mesh_lib.batch_specs(b0, plan))))
        for tokens, pos in data["steps"]:
            logits, cache = dec(params, cache, {"tokens": jnp.asarray(tokens),
                                                "pos": jnp.int32(pos)})
            rec["decode"].append(np.asarray(logits, np.float32))
        if "prompt" in data:
            batch = {"tokens": jnp.asarray(data["prompt"])}
            pre = jax.jit(steps.make_prefill_step(cfg), in_shardings=(
                ps, sh(mesh_lib.batch_specs(batch, plan))))
            rec["prefill"] = np.asarray(pre(params, batch), np.float32)
    out[arch] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""

# (arch, mesh, prefill too): GQA, Mamba-2 and MLA + MoE (data 1)
REF_CELLS = [("tinyllama-1.1b", (2, 2), False), ("mamba2-1.3b", (2, 2), True),
             ("deepseek-v2-236b", (1, 4), True)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded decode (and prefill) steps of each
    ``REF_CELLS`` cell from its own weights and this file's cache."""
    d = tmp_path_factory.mktemp("ref")
    data = {}
    for arch, _, prefill in REF_CELLS:
        cfg = get_config(arch).reduced()
        data[arch] = {"batch": B, "seq": S, "steps": [
            (t.numpy(), p) for t, p in _steps(cfg)],
            "cache": lm_cache_to_numpy(_cache(cfg), cfg)}
        if prefill:
            data[arch]["prompt"] = np.random.default_rng(6).integers(
                0, cfg.vocab, (B, 32)).astype(np.int32)
    with open(d / "job.pkl", "wb") as f:
        pickle.dump({"cells": [(a, s) for a, s, _ in REF_CELLS],
                     "data": data}, f)
    (d / "ref.py").write_text(REF_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "job.pkl"),
                        str(d / "out.pkl")], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(REPO))
    assert r.returncode == 0 and "REF_OK" in r.stdout, \
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-3000:]}"
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f), data


@pytest.mark.parametrize("arch,shape,prefill", REF_CELLS,
                         ids=[a for a, _, _ in REF_CELLS])
def test_decode_matches_reference_sharded_step(groups, reference, arch,
                                               shape, prefill):
    """Each step's logits (and the prefill's) of the tensor-parallel port
    against the reference's sharded step: no further from it than the
    mesh-less port is, plus 2^-7 of their scale; the mesh-less port's own
    gap within ``test_torch_lm.py``'s LOGIT_TOL (the two packages' bf16
    roundings: torch's SiLU rounds once where XLA's logistic rounds three
    times, 1.0-2.8% of the scale over these four steps)."""
    ref, data = reference
    ref, data = ref[arch], data[arch]
    cfg = get_config(arch).reduced()
    model = lm_params_from_numpy(ref["params"], cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    steps = [(torch.as_tensor(t), p) for t, p in data["steps"]]
    group = groups[shape[0] * shape[1]]
    outs = group.run(tasks.tp_decode, (
        cfg, shape, sd, lm_cache_from_numpy(data["cache"], cfg), steps))
    port = _mesh_less(cfg, model, lm_cache_from_numpy(data["cache"], cfg),
                      steps, False)[0]
    cases = [(list(zip((o["first"] for o in outs), ts)), p,
              torch.as_tensor(w))
             for ts, p, w in zip(zip(*(o["logits"] for o in outs)), port,
                                 ref["decode"])]
    if prefill:
        batch = {"tokens": torch.as_tensor(data["prompt"])}
        res = group.run(tasks.tp_prefill, (cfg, shape, sd, batch))
        with torch.no_grad():
            whole = steps_lib.make_prefill_step(cfg)(model, batch).float()
        cases.append(([(first, lg.float()) for lg, first, _ in res], whole,
                      torch.as_tensor(ref["prefill"])))
    for pieces, port_lg, want in cases:
        scale = float(want.abs().max())
        gap = float((port_lg - want).abs().max())
        assert gap <= REF_GAP_TOL * scale, gap / scale
        for first, lg in pieces:
            err = float((lg - want[first:first + lg.shape[0]]).abs().max())
            assert err <= gap + LOGITS_TOL * scale, (err, gap, scale)
