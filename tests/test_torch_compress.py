"""int8 compressed gradient sum (``repro_torch.optim.compress``) on gloo
ranks, against the reference's ``int8_psum`` / ``compressed_tree_psum``
and against the exact sum: the reference's ``tests/test_compress.py`` (a
(2, 4) ("pod", "data") mesh of fake devices there).

The reference runs in a subprocess on a (2, 2) ("pod", "data") mesh of
fake host devices, the port on (2, 2) CPU ranks, on the same gradients.
Both quantize alike (float32 division, round half to even: the int8 rows
and scales agree bit for bit), but XLA contracts the second pod's
dequantize-and-add into one fused multiply-add where the port rounds the
product first, so every rank's sum is held to the reference's pod's
within two float32 ulps of the largest sum (2^-22 x max |sum|; measured
4.8e-7, one ulp, at a max of 5.5).  Beside it, the reference test's bound against the exact
sum: error at most 2 x max |g| / 127 (one int8 step of each pod's row
maximum, two pods)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_launch_ranks as tasks
from repro_torch.core.party_group import PartyGroup
from repro_torch.optim.compress import _quant_rows

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import inspect
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

from repro.launch import mesh as mesh_lib
from repro.optim.compress import compressed_tree_psum, int8_psum

mesh = mesh_lib.make_mesh((2, 2), ("pod", "data"))
g = np.load(sys.argv[1])

def body(gl):
    mine = gl[0]
    tree = compressed_tree_psum({"a": mine, "b": None, "c": mine[0]}, "pod")
    return int8_psum(mine, "pod")[None], tree["a"][None], tree["c"][None]

_check = ({"check_vma": False}
          if "check_vma" in inspect.signature(shard_map_fn).parameters
          else {"check_rep": False})
spec = P("pod", None, None)
f = shard_map_fn(body, mesh=mesh, in_specs=spec,
                 out_specs=(spec, spec, P("pod", None)), **_check)
total, a, c = (np.asarray(t) for t in jax.jit(f)(g))
np.savez(sys.argv[2], total=total, a=a, c=c)
print("REF_OK")
"""


def _grads() -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, 64, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-pod sums of ``_grads()`` (each (2, ...): one a
    pod), from its own process with four fake devices."""
    d = tmp_path_factory.mktemp("ref")
    script = d / "compress.py"
    script.write_text(SCRIPT)
    np.save(d / "g.npy", _grads().numpy())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(d / "g.npy"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(REPO))
    assert r.returncode == 0 and "REF_OK" in r.stdout, \
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-3000:]}"
    with np.load(d / "out.npz") as f:
        return {k: torch.as_tensor(v) for k, v in f.items()}


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=120, ranks=4) as g:
        yield g


def test_int8_psum_matches_exact(group):
    g = _grads()
    outs = group.run(tasks.compress, (g,))
    want = g.sum(0)
    tol = 2 * float(g.abs().max()) / 127
    for got, tree in outs:
        # every rank holds the same sum
        assert torch.equal(got, outs[0][0])
        err = float((got - want).abs().max())
        assert err <= tol, (err, tol)
        assert tree["b"] is None and list(tree) == ["a", "b", "c"]
        assert torch.equal(tree["a"], got)
        assert float((tree["c"] - want[0]).abs().max()) <= tol


def test_int8_psum_equals_reference(group, reference):
    outs = group.run(tasks.compress, (_grads(),))
    for r, (got, tree) in enumerate(outs):
        pod = r // 2                      # rank r: pod r // 2, data r % 2
        for k, t in (("total", got), ("a", tree["a"]), ("c", tree["c"])):
            want = reference[k][pod]
            tol = 2 ** -22 * float(want.abs().max())
            err = float((t - want).abs().max())
            assert err <= tol, (r, k, err, tol)


def test_quant_rows_step_is_one_int8_step_of_the_row_max():
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(5, 7)).astype(np.float32))
    q, s = _quant_rows(x)
    assert q.dtype == torch.int8 and s.shape == (5, 1)
    assert int(q.abs().max()) == 127
    err = (q.float() * s - x).abs()
    assert bool((err <= s / 2 + 1e-7).all())
