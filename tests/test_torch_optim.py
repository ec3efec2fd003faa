"""The port's AdamW / SGD against the JAX package's: three steps of AdamW
with float32 moments and with the int8 / uint8 block-quantized moments,
SGD, the warm-up schedule and the global norm, on the same parameters and
gradients (a leaf with no gradient, as a BN running statistic, is the
reference's zero cotangent).

Tolerance: 1e-6 absolute on every parameter, moment and scale, 1e-6 of
its value on the global norm (the elementwise float32 arithmetic is the
same; ``pow``, ``sqrt`` and the sums may round one ulp apart), and the
int8 / uint8 codes equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

torch.set_num_threads(1)

TOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"l0_w": rng.normal(0, 0.5, (5, 7)).astype(np.float32),
            "l0_b": rng.normal(0, 0.1, (7,)).astype(np.float32),
            "l1_mu": rng.normal(0, 1, (7,)).astype(np.float32),
            "l2_w": rng.normal(0, 0.5, (3, 4, 6)).astype(np.float32)}


def _grads(step, scale):
    """Gradients of every leaf but ``l1_mu`` (None in the port, zeros in
    the reference)."""
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(0, scale, v.shape).astype(np.float32)
                if k != "l1_mu" else None)
            for k, v in _params().items()}


def _torch(d):
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in d.items()}


def _jax(d, like):
    return {k: jnp.asarray(v if v is not None else np.zeros_like(like[k]))
            for k, v in d.items()}


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _norm_close(got, want):
    _close(got, want, TOL * max(1.0, abs(float(want))))


def _codes_equal(got, want):
    assert np.array_equal(got.numpy(), np.asarray(want))


# grad scale 3.0 puts the global norm above grad_clip (clipping on)
@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("gscale", [0.05, 3.0])
def test_adamw_three_steps(state_dtype, gscale):
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=4, grad_clip=1.0,
                  state_dtype=state_dtype)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), adamw.OptConfig(**cfg_kw)
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = _torch(p0)
    jo, to = jadamw.adamw_init(jp, jcfg), adamw.adamw_init(tp, tcfg)
    for step in range(3):
        g = _grads(step, gscale)
        jp, jo, jn = jadamw.adamw_update(jp, _jax(g, p0), jo, jcfg)
        tp, to, tn = adamw.adamw_update(tp, _torch(g), to, tcfg)
        _norm_close(tn, jn)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        for k in p0:
            _close(tp[k], jp[k])
            if state_dtype == "fp32":
                _close(to["m"][k], jo["m"][k])
                _close(to["v"][k], jo["v"][k])
            else:
                _codes_equal(to["m"][k]["q8"], jo["m"][k]["q8"])
                _codes_equal(to["v"][k]["qu8"], jo["v"][k]["qu8"])
                _close(to["m"][k]["s8"], jo["m"][k]["s8"])
                _close(to["v"][k]["su8"], jo["v"][k]["su8"])
    # weight decay moved the leaf with no gradient
    assert not np.array_equal(tp["l1_mu"].numpy(), p0["l1_mu"])


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_adamw_updates_in_place(state_dtype):
    """The step writes the caller's own tensors (parameters, float32
    moments) and dicts, as the reference's jitted steps donate them; the
    values are the ones ``test_adamw_three_steps`` holds."""
    cfg = adamw.OptConfig(lr=1e-2, weight_decay=0.1, warmup_steps=4,
                          state_dtype=state_dtype)
    params = _torch(_params())
    state = adamw.adamw_init(params, cfg)
    held = dict(params), dict(state["m"]), dict(state["v"])
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    before = {k: p.clone() for k, p in params.items()}
    for step in range(3):
        p2, s2, _ = adamw.adamw_update(params, _torch(_grads(step, 3.0)),
                                       state, cfg)
        assert p2 is params and s2 is state
        assert int(state["step"]) == step + 1
    for k in params:
        assert params[k] is held[0][k] and params[k].data_ptr() == ptrs[k]
        assert not torch.equal(params[k], before[k]), k
        if state_dtype == "fp32":
            assert state["m"][k] is held[1][k] and state["v"][k] is held[2][k]
        else:   # requantized into the caller's state dict
            assert state["m"][k] is not held[1][k], k
    if state_dtype == "int8":
        assert state["m"]["l0_w"]["q8"].abs().max() > 0


def test_sgd_and_schedule():
    cfg = dict(lr=0.1, warmup_steps=5)
    jcfg, tcfg = jadamw.OptConfig(**cfg), adamw.OptConfig(**cfg)
    p0 = _params()
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _torch(p0)
    jo = {"step": jnp.zeros((), jnp.int32)}
    to = {"step": torch.zeros((), dtype=torch.int32)}
    for step in range(3):
        g = _grads(step, 1.0)
        jp, jo, jn = jadamw.sgd_update(jp, _jax(g, p0), jo, jcfg)
        tp, to, tn = adamw.sgd_update(tp, _torch(g), to, tcfg)
        _norm_close(tn, jn)
        for k in p0:
            _close(tp[k], jp[k])
    # warm-up: (step + 1) / warmup with step already incremented
    for s in range(1, 8):
        _close(adamw._schedule(tcfg, torch.tensor(s, dtype=torch.int32)),
               jadamw._schedule(jcfg, jnp.int32(s)), 0)
    assert float(adamw._schedule(tcfg, torch.tensor(1))) == \
        pytest.approx(0.1 * 2 / 5)


def test_int8_state_layout():
    p = _torch(_params())
    st = adamw.adamw_init(p, adamw.OptConfig(state_dtype="int8"))
    jst = jadamw.adamw_init({k: jnp.asarray(v.numpy()) for k, v in
                             p.items()}, jadamw.OptConfig(state_dtype="int8"))
    for k in p:
        for mom, keys in (("m", ("q8", "s8")), ("v", ("qu8", "su8"))):
            for q in keys:
                got, want = st[mom][k][q], jst[mom][k][q]
                assert tuple(got.shape) == want.shape
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
