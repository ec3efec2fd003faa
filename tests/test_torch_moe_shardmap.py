"""The "shardmap" MoE (``repro_torch.nn.moe``: expert parallelism with an
explicit all-to-all over the mesh's "model" axis) on a (2, 2) ("data",
"model") mesh of gloo CPU ranks, against the reference's "shardmap" MoE
and against the port's "dense" dispatch: the reference's
``tests/test_moe_shardmap.py`` (its widths: b 4, s 8, d 16, 8 experts,
top-2, d_ff 32, capacity factor 8, so nothing drops).

The reference runs in a subprocess on a (2, 2) mesh of fake host devices,
on the same weights and inputs, forward and the gradient of its output's
sum.  Each rank's output is held to the reference's on the rank's data
shard within 2^-7 of max |y| (bf16 products and outputs on both sides,
the routing float32 on both; measured 6.2e-3 of it, under two bf16
ulps), and the ranks' expert gradients, summed, to the reference's
within 2^-6 of its scale (measured at most 3.9e-3).

Beside it, each rank's output on its data shard is held to the dense dispatch of
that shard within the reference's bound, 0.15 of max |y|; the gradient
through both all-to-alls is finite and non-zero on every rank, and the
expert weights' gradients summed over the ranks equal the dense
dispatch's gradient of the whole batch within 2^-6 of its scale (bf16
products)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_launch_ranks as tasks
from repro_torch.core.party_group import PartyGroup
from repro_torch.nn import moe

torch.set_num_threads(1)

B, S, D, E, K, DFF = 4, 8, 16, 8, 2, 32
CF = 8.0
NAMES = ("router", "w_up", "w_gate", "w_down")
REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import numpy as np
import jax
import jax.numpy as jnp

from repro.launch import mesh as mesh_lib
from repro.launch.context import use_plan
from repro.nn import moe

mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
plan = mesh_lib.Plan(mesh)
with np.load(sys.argv[1]) as f:
    src = dict(f)
x = jnp.asarray(src.pop("x"))
p = {k: jnp.asarray(v) for k, v in src.items()}
run = dict(top_k=2, act="silu", gated=True, capacity_factor=8.0)
moe.set_moe_impl("shardmap")
with mesh, use_plan(plan):
    y = jax.jit(lambda pp, xx: moe.moe_ffn(
        pp, xx.astype(jnp.bfloat16), **run))(p, x)
    g = jax.jit(jax.grad(lambda pp: moe.moe_ffn(
        pp, x.astype(jnp.bfloat16), **run).astype(jnp.float32).sum()))(p)
moe.set_moe_impl("dense")
np.savez(sys.argv[2], y=np.asarray(y, np.float32),
         **{k: np.asarray(v) for k, v in g.items()})
print("REF_OK")
"""


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=120, ranks=4) as g:
        yield g


def _setup():
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, D, DFF, E, gated=True)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 0.5, (B, S, D)).astype(np.float32))
    return p, x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's "shardmap" output (B, S, D) and gradients on
    ``_setup()``'s weights and inputs, from its own process with four
    fake devices."""
    p, x = _setup()
    d = tmp_path_factory.mktemp("ref")
    script = d / "moe_sm.py"
    script.write_text(SCRIPT)
    np.savez(d / "in.npz", x=x.numpy(),
             **{k: v.numpy() for k, v in p.state_dict().items()})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(REPO))
    assert r.returncode == 0 and "REF_OK" in r.stdout, \
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-3000:]}"
    with np.load(d / "out.npz") as f:
        return {k: torch.as_tensor(v) for k, v in f.items()}


def _run(group):
    p, x = _setup()
    return group.run(tasks.moe_shardmap,
                     ((2, 2), {k: v.clone() for k, v in
                               p.state_dict().items()}, x, CF))


def test_shardmap_equals_reference_shardmap(group, reference):
    outs = _run(group)
    want = reference["y"]
    for r, (y, _) in enumerate(outs):
        d = r // 2                                   # the rank's data row
        ref = want[d * 2:(d + 1) * 2]
        err = float((ref - y).abs().max())
        assert err <= 2 ** -7 * float(want.abs().max()), (r, err)
    for i, k in enumerate(NAMES[1:], 1):
        got = sum(o[1][i] for o in outs) / 2         # model ranks agree
        w = reference[k]
        err = float((got - w).abs().max())
        assert err <= 2 ** -6 * float(w.abs().max()), (k, err)


def test_shardmap_matches_dense_and_takes_gradients(group):
    p, x = _setup()
    outs = _run(group)
    run = dict(top_k=K, act="silu", gated=True, capacity_factor=CF)
    for r, (y, grads) in enumerate(outs):
        d = r // 2                                   # the rank's data row
        xl = x[d * 2:(d + 1) * 2].bfloat16()
        dense = moe.moe_ffn(p, xl, **run).float()
        err = float((dense - y).abs().max())
        assert err < 0.15 * max(float(dense.abs().max()), 1e-3), (r, err)
        gn = sum(float(g.abs().sum()) for g in grads)
        assert np.isfinite(gn) and gn > 0, (r, gn)
    # the experts' gradients over the four ranks == dense's of the batch
    # (each data row's two ranks split its tokens: the model axis sums)
    ps = [p.router, p.w_up, p.w_gate, p.w_down]
    for t in ps:
        t.requires_grad_(True)
    want = torch.autograd.grad(
        moe.moe_ffn(p, x.bfloat16(), **run).float().sum(), ps)
    for i, w in enumerate(want[1:], 1):
        got = sum(o[1][i] for o in outs) / 2         # model ranks agree
        assert float((got - w).abs().max()) \
            <= 2 ** -6 * float(w.abs().max()), i


def test_shardmap_without_a_plan_is_dense():
    p, x = _setup()
    run = dict(top_k=K, act="silu", gated=True, capacity_factor=CF)
    want = moe.moe_ffn(p, x.bfloat16(), **run)
    moe.set_moe_impl("shardmap")
    try:
        got = moe.moe_ffn(p, x.bfloat16(), **run)
    finally:
        moe.set_moe_impl("dense")
    assert torch.equal(got, want)
