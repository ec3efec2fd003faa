"""The port's MoE FFN (``repro_torch/nn/moe.py``) against the JAX package's
``repro/nn/moe.py``: routing, scatter, expert products and combine.

Inputs are on the bf16 grid (tokens, router and expert weights), so both
sides start from the same bf16 values.  Tolerances: the routing (expert
ids, positions in the expert, the keep mask) and the scattered buffer are
equal; the outputs agree within one bf16 rounding of their scale (2^-7 of
max |y|): the bf16 products of the two frameworks sum in other orders and
may round one ulp apart, which the next product carries on.  The chosen
seeds' least router margin (the least gap between consecutive ones of a
token's k + 1 largest probabilities) is asserted above 1e-4, far above the
float32 noise of a router logit (~1e-7), so that equal routing is not
luck."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.nn import moe
from repro_torch.nn.layers import MLP

torch.set_num_threads(1)

B, S, D, E, K, DFF = 4, 8, 16, 8, 2, 32
MARGIN = 1e-4


def _bf16_grid(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _params(seed: int, gated: bool, n_shared: int):
    """The reference's ``moe_init`` leaves, rounded to the bf16 grid, and
    the port's ``MoE`` holding the same values."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, DFF, E, gated, n_shared,
                       DFF * max(1, n_shared))
    jp = jax.tree.map(lambda a: _bf16_grid(np.asarray(a)), jp)
    p = moe.MoE(D, DFF, E, gated, n_shared, DFF * max(1, n_shared),
                device="meta")
    flat = {k: v for k, v in jp.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in jp.get("shared", {}).items()})
    p.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                      strict=True, assign=True)
    return jax.tree.map(jnp.asarray, jp), p


def _x(seed: int) -> np.ndarray:
    return _bf16_grid(np.random.default_rng(seed).normal(0, 1, (B, S, D))
                      .astype(np.float32))


def _margin(x: np.ndarray, router) -> float:
    """Least gap between consecutive ones of a token's K + 1 largest router
    probabilities: what decides the chosen experts and their order."""
    probs = torch.softmax(torch.tensor(x).reshape(-1, D).double()
                          @ torch.tensor(np.asarray(router)).double(), -1)
    top = probs.topk(K + 1, dim=-1).values
    return float((top[:, :-1] - top[:, 1:]).min())


@pytest.fixture
def dispatch():
    """Sets the dispatch mode of both packages; restores "sort" after."""
    def set_mode(mode):
        moe.set_dispatch_mode(mode)
        jmoe.set_dispatch_mode(mode)
    yield set_mode
    set_mode("sort")


@pytest.mark.parametrize("capacity", [B * S * K, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_local_dispatch_matches_reference(seed, capacity):
    """``_local_dispatch``: the same routing, slots, gates and buffer."""
    jp, p = _params(seed, True, 0)
    x = _x(seed + 10)
    assert _margin(x, jp["router"]) > MARGIN
    xt = x.reshape(-1, D)
    want = jmoe._local_dispatch(jnp.asarray(xt, jnp.bfloat16), jp["router"],
                                K, capacity)
    got = moe._local_dispatch(torch.as_tensor(xt).bfloat16(), p.router, K,
                              capacity)
    buf, flat_e, idx_c, keep, gates = got
    for a, b in zip((buf, flat_e, idx_c, keep), want[:4]):
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b).astype(np.float32))
    assert bool(keep.all()) == (capacity == B * S * K)
    np.testing.assert_allclose(gates.numpy(), np.asarray(want[4]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["sort", "cumsum"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_matches_reference(dispatch, mode, capacity_factor, n_shared,
                                   gated):
    """``moe_ffn`` in both dispatch modes, gated and not, with and without a
    shared expert, without drops (capacity factor 8, as the reference's
    shard_map test) and with them (1.25): the routing of every (token,
    choice) equals the reference's sort-mode ``_local_dispatch`` and the
    outputs agree within one bf16 rounding."""
    dispatch(mode)
    jp, p = _params(3, gated, n_shared)
    x = _x(4)
    assert _margin(x, jp["router"]) > MARGIN
    act = "silu" if gated else "sq_relu"
    want = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), top_k=K, act=act,
                        gated=gated, capacity_factor=capacity_factor)
    xb = torch.as_tensor(x).bfloat16()
    with moe.record_routing() as routes:
        got = moe.moe_ffn(p, xb, top_k=K, act=act, gated=gated,
                          capacity_factor=capacity_factor)
    assert got.shape == (B, S, D) and got.dtype == torch.bfloat16
    capacity = max(1, int(capacity_factor * B * S * K / E))
    _, w_e, w_c, w_keep, _ = jmoe._local_dispatch(
        jnp.asarray(x.reshape(-1, D), jnp.bfloat16), jp["router"], K,
        capacity)
    (flat_e, pos, keep, _), = routes
    assert np.array_equal(flat_e.numpy(), np.asarray(w_e))
    assert np.array_equal(keep.numpy(), np.asarray(w_keep))
    assert np.array_equal(torch.where(keep, pos, capacity - 1).numpy(),
                          np.asarray(w_c))
    assert bool(keep.all()) == (capacity_factor == 8.0)
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2.0 ** -7 * float(np.abs(want).max()), err


def test_expert_compute_matches_reference():
    """The expert FFNs on one scattered buffer: bf16 batched products."""
    jp, p = _params(5, True, 0)
    buf = _bf16_grid(np.random.default_rng(6).normal(0, 1, (E, 5, D))
                     .astype(np.float32))
    want = np.asarray(jmoe._expert_compute(
        jp, jnp.asarray(buf, jnp.bfloat16), "silu", True)
        .astype(jnp.float32))
    got = moe._expert_compute(p, torch.as_tensor(buf).bfloat16(), "silu",
                              True).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_moe_init_shapes_and_distributions():
    """The port's own init: the reference's leaves, shapes and scales
    (experts N(0, 1) / sqrt(d_in), the router uniform ±1/sqrt(d))."""
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 64, 128, 16, True, 1, 128)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 64, 128, 16, True, 1, 128)
    sd = p.state_dict()
    ref = {k: v for k, v in jp.items() if k != "shared"}
    ref.update({f"shared.{k}": v for k, v in jp["shared"].items()})
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert isinstance(p.shared, MLP)
    assert abs(float(p.w_up.std()) - 1 / 8) < 0.005
    assert abs(float(p.w_down.std()) - 1 / np.sqrt(128)) < 0.005
    assert float(p.router.abs().max()) <= 1 / 8
    ungated = moe.moe_init(gen, 64, 128, 16, False)
    assert ungated.w_gate is None and ungated.shared is None


def test_shardmap_impl_and_unknown_modes_raise():
    """"shardmap" is taken (it dispatches on a mesh plan only:
    ``test_torch_moe_shardmap.py``); unknown modes raise."""
    moe.set_moe_impl("shardmap")
    assert moe._MOE_IMPL == "shardmap"
    moe.set_moe_impl("dense")
    assert moe._MOE_IMPL == "dense"
    with pytest.raises(ValueError):
        moe.set_moe_impl("ragged")
    with pytest.raises(ValueError):
        moe.set_dispatch_mode("scan")



def test_replay_routing_takes_the_given_choices():
    """Inside ``replay_routing`` a call routes to the given experts: the
    recorded choices of a run give that run's output bit for bit, no token
    changed; each token's 2nd and 3rd experts in their place route there,
    gated by its own router probabilities of them, renormalised, and every
    token counts as changed."""
    _, p = _params(5, True, 1)
    xb = torch.as_tensor(_x(6)).bfloat16()
    run = dict(top_k=K, act="silu", gated=True)
    with moe.record_routing() as rec:
        want = moe.moe_ffn(p, xb, **run)
    queue = [rec[0][0].clone()]
    with moe.replay_routing(queue) as changed:
        got = moe.moe_ffn(p, xb, **run)
    assert torch.equal(got, want) and changed == [0] and not queue
    probs = rec[0][3]
    other = probs.topk(K + 1, dim=-1).indices[:, 1:]
    with moe.replay_routing([other.reshape(-1)]) as changed, \
            moe.record_routing() as rec2:
        moe.moe_ffn(p, xb, **run)
    assert changed == [B * S]
    assert torch.equal(rec2[0][0], other.reshape(-1))
    with moe.replay_routing([other]):
        _, gates, idx = moe._gates(xb.reshape(-1, D), p.router, K)
    vals = probs.gather(-1, other)
    assert torch.equal(idx, other)
    assert torch.equal(gates, vals / (vals.sum(-1, keepdim=True) + 1e-9))
