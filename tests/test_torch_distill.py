"""The port's training and distillation half of CBNN against the JAX
package: the synthetic data, the STE Sign, the training-mode BNN forward,
the KD loss, one training step, the secure accuracy of a trained student
and the pipeline's rows.

Tolerances:
* data, ``sign_ste`` (forward and gradient), the maxpool gradient under
  ties, the secure logits and accuracy: exact.
* training-mode logits and BN batch statistics, ``kd_loss`` and its
  gradient, the step's loss (each relative to max(1, its scale)), the
  AdamW moments and the running statistics: 1e-6 (float32 convolutions
  and sums round in another order); the full-precision teacher's logits
  and batch statistics 1e-5 of their scale (its ReLU convolutions carry
  the summation order on: 3.0e-6 and 1.8e-6 measured on this tree, where
  a Sign net's read within 1e-6).
* the parameters after one AdamW step: 1e-6 wherever the reference's
  gradient is above ``NOISE`` x its largest gradient.  Below it the
  gradient is rounding noise (a bias followed by a training-mode BN has
  the analytic gradient 0; a sum of ±1 terms can cancel), and the first
  AdamW step normalises any such value to about ±lr, so the two
  frameworks' noise lands up to 2·lr apart; those elements are held to
  2·lr + 1e-6.  Measured on this tree: 2,661 of MnistNet3-sep's 78,400
  fc weights and every conv/fc bias before a BN, all with |g| <= 1.5e-6
  (4.4e-6 of the largest gradient).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import image_dataset as jimage_dataset
from repro.data import token_stream as jtoken_stream
from repro.distill import kd as jkd
from repro.distill import pipeline as jpipe
from repro.nn import bnn as jbnn
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.data import image_dataset, token_stream
from repro_torch.distill import kd, pipeline
from repro_torch.launch import distill as distill_cli
from repro_torch.nn import bnn
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

TOL = 1e-6
NOISE = 2e-5
LR, WARMUP = 2e-3, 20
LR_STEP1 = LR * 2 / WARMUP          # the warm-up factor at step 1


@pytest.fixture(scope="module")
def mnist():
    return jimage_dataset("mnist-syn", seed=3)


def _ref_params(net, seed=0):
    return {k: np.asarray(v) for k, v in
            jbnn.init_bnn(jax.random.PRNGKey(seed), net).items()}


def _rel_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mnist-syn", "cifar-syn"])
def test_image_dataset_bit_identical(name):
    for got, want in zip(image_dataset(name, seed=3),
                         jimage_dataset(name, seed=3)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_token_stream_bit_identical():
    for kw in ({}, {"start_step": 5}, {"shard": (1, 2), "seed": 4}):
        ours, theirs = token_stream(4, 16, 512, **kw), \
            jtoken_stream(4, 16, 512, **kw)
        for _ in range(3):
            (b1, s1), (b2, s2) = next(ours), next(theirs)
            assert s1 == s2
            for k in ("tokens", "labels"):
                assert np.array_equal(b1[k], b2[k])


# -- the training forward --------------------------------------------------

def test_sign_ste_forward_and_gradient():
    x = np.array([-2.0, -1.0000001, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0,
                  1.0000001, 2.0], np.float32)
    up = np.arange(1, len(x) + 1, dtype=np.float32)
    want_y = np.asarray(jbnn.sign_ste(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda v: (jbnn.sign_ste(v) * up).sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    y = bnn.sign_ste(t)
    (y * torch.from_numpy(up)).sum().backward()
    assert np.array_equal(y.detach().numpy(), want_y)
    assert np.array_equal(t.grad.numpy(), want_g)
    # x >= 0 -> +1 (-0.0 too); the clipped STE passes |x| <= 1 inclusive
    assert want_y[4] == 1.0 and list(want_g[[1, 2, 7, 8]]) == [0, 3, 8, 0]


def test_maxpool_gradient_goes_to_the_first_tie():
    """After a Sign nearly every 2x2 window ties: the gradient must go to
    the window's first maximum in row-major order, as the reference's
    select-and-scatter sends it."""
    rng = np.random.default_rng(0)
    x = np.where(rng.random((2, 8, 8, 3)) < 0.5, 1.0, -1.0) \
        .astype(np.float32)
    x[:, :2, :2, :] = 1.0                  # a full four-way tie
    g = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: (jax.lax.reduce_window(
        v, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        * g).sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    (bnn._maxpool(t) * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(t.grad.numpy(), want)
    assert (t.grad.numpy()[:, 0, 0] == g[:, 0, 0]).all()


@pytest.mark.parametrize("net,binarize,tol", [("MnistNet3-sep", True, TOL),
                                              ("MnistNet4", False, 1e-5)])
def test_train_forward_matches_reference(net, binarize, tol):
    params = _ref_params(net)
    x = np.random.default_rng(1).normal(
        0, 0.5, (8,) + bnn.INPUT_SHAPES[net]).astype(np.float32)
    want, wstats = jax.jit(lambda p, v: jbnn.bnn_forward(
        p, v, net, train=True, binarize=binarize))(params, x)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(params).items()}
    got, stats = bnn.bnn_forward(leaves, torch.from_numpy(x), net,
                                 train=True, binarize=binarize)
    assert got.requires_grad           # the training forward records a graph
    _rel_close(got, want, tol)
    assert sorted(stats) == sorted(wstats)
    for k in stats:
        _rel_close(stats[k], wstats[k], tol)


@pytest.mark.parametrize("lam", [1.0, 0.1])
def test_kd_loss_value_and_gradient(lam):
    rng = np.random.default_rng(2)
    s = rng.normal(0, 2, (16, 10)).astype(np.float32)
    t = rng.normal(0, 3, (16, 10)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    for teacher in (None, t):
        jt = None if teacher is None else jnp.asarray(teacher)
        want, wg = jax.value_and_grad(lambda v: jkd.kd_loss(
            v, jnp.asarray(y), jt, lam, 10.0))(jnp.asarray(s))
        ts = torch.tensor(s, requires_grad=True)
        got = kd.kd_loss(ts, torch.from_numpy(y),
                         None if teacher is None else torch.from_numpy(t),
                         lam, 10.0)
        got.backward()
        _rel_close(got, want)
        _rel_close(ts.grad, wg)


# -- one training step -------------------------------------------------------

def _ref_step(params, xb, yb, tlogits, net, lam, binarize):
    """The reference's ``train_bnn`` step (its jitted body), returning the
    optimizer state and gradient too."""
    ocfg = JOptConfig(lr=LR, weight_decay=1e-4, warmup_steps=WARMUP,
                      grad_clip=5.0)

    def loss_fn(p):
        logits, stats = jbnn.bnn_forward(p, xb, net, train=True,
                                         binarize=binarize)
        return jkd.kd_loss(logits, yb, tlogits, lam, 10.0), stats

    @jax.jit
    def step(p, o):
        (loss, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        p2, o2, _ = jadamw_update(p, g, o, ocfg)
        for k, v in stats.items():
            p2[k] = 0.9 * p2[k] + (1 - 0.9) * v
        return p2, o2, loss, g

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return step(jp, jadamw_init(jp))


def _check_params(got: dict, want: dict, grads: dict):
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    for k in want:
        d = np.abs(got[k].numpy() - np.asarray(want[k]))
        noise = np.abs(np.asarray(grads[k])) <= NOISE * gmax
        assert (d[~noise] <= TOL).all(), (k, float(d[~noise].max()))
        assert (d[noise] <= 2 * LR_STEP1 + TOL).all(), k


@pytest.mark.parametrize("net,teacher,lam,binarize", [
    ("MnistNet3-sep", "MnistNet4", 0.1, True),   # student, KD, maxpool ties
    ("MnistNet4", None, 1.0, False)])            # the teacher itself
def test_one_train_step_matches_reference(mnist, monkeypatch, net, teacher,
                                          lam, binarize):
    """``train_bnn`` for one step (128 images, batch 128) from the
    reference's initial params, against the reference's step on the same
    batch: loss, params, AdamW moments, running statistics."""
    x_tr, y_tr, x_te, y_te = mnist
    p0 = _ref_params(net)
    tparams = _ref_params(teacher, seed=1) if teacher else None
    # the reference's step on train_bnn's first batch
    idx = np.random.default_rng(0).permutation(128)
    xb, yb = x_tr[idx], y_tr[idx]
    tl = None
    if teacher:
        tl, _ = jax.jit(lambda p, v: jbnn.bnn_forward(
            p, v, teacher, binarize=False))(tparams, xb)
    jp2, jo2, jloss, jg = _ref_step(p0, jnp.asarray(xb), jnp.asarray(yb), tl,
                                    net, lam, binarize)

    # the port's train_bnn starts from the reference's initial params
    monkeypatch.setattr(bnn, "init_bnn", lambda seed, name, device=None:
                        params_from_numpy(_ref_params(name, seed), device))
    res = kd.train_bnn(net, (x_tr[:128], y_tr[:128], x_te[:8], y_te[:8]),
                       epochs=1, batch=128, lam=lam, binarize=binarize,
                       teacher=tparams and (params_from_numpy(tparams),
                                            teacher), device="cpu")
    assert len(res.history) == 1
    assert res.param_count == jbnn.param_count(p0)
    _rel_close(np.float32(res.history[0][1]), jloss)
    _check_params(res.params, jp2, jg)

    # the same step through the port's step function, moments included
    ttl = None if tl is None else torch.from_numpy(np.array(tl))
    ocfg = OptConfig(lr=LR, weight_decay=1e-4, warmup_steps=WARMUP,
                     grad_clip=5.0)
    tp = params_from_numpy(p0)
    p2, o2, loss = kd._train_step(
        tp, adamw_init(tp), torch.from_numpy(xb), torch.from_numpy(yb), ttl,
        net=net, ocfg=ocfg, lam=lam, temperature=10.0, binarize=binarize,
        bn_momentum=0.9)
    _rel_close(loss, jloss)
    close = np.testing.assert_allclose
    for k in p0:
        close(o2["m"][k].numpy(), np.asarray(jo2["m"][k]), rtol=0, atol=TOL)
        close(o2["v"][k].numpy(), np.asarray(jo2["v"][k]), rtol=0, atol=TOL)
        if k.endswith(("_mu", "_var")):          # the running statistics
            close(p2[k].numpy(), np.asarray(jp2[k]), rtol=0, atol=TOL)
    assert int(o2["step"]) == 1


# -- secure accuracy and the pipeline ---------------------------------------

@pytest.fixture(scope="module")
def trained_mnistnet1(mnist):
    """A student trained in the port (one epoch on 256 images)."""
    x_tr, y_tr, x_te, y_te = mnist
    res = kd.train_bnn("MnistNet1", (x_tr[:256], y_tr[:256], x_te[:32],
                                     y_te[:32]), epochs=1, device="cpu")
    return res.params, x_te[:32], y_te[:32]


def _record_logits(monkeypatch, module):
    seen = []
    inner = module.secure_infer

    def rec(*a, **k):
        out = inner(*a, **k)
        seen.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor)
                               else out))
        return out
    monkeypatch.setattr(module, "secure_infer", rec)
    return seen


@pytest.mark.parametrize("mode", ["shared", "public"])
def test_secure_accuracy_bit_identical(monkeypatch, trained_mnistnet1, mode):
    params, x, y = trained_mnistnet1
    got_logits = _record_logits(monkeypatch, pipeline)
    want_logits = _record_logits(monkeypatch, jpipe)
    got = pipeline._secure_accuracy(params, "MnistNet1", x, y,
                                    mode_kw=pipeline.MODES[mode], seed=2)
    want = jpipe._secure_accuracy(params_to_numpy(params), "MnistNet1", x, y,
                                  mode_kw=jpipe.MODES[mode], seed=2)
    assert len(got_logits) == len(want_logits) == 2
    for a, b in zip(got_logits, want_logits):
        assert np.array_equal(a, b)
    assert got == want
    # the reference's own pin: secure accuracy == plaintext accuracy
    assert got == kd.evaluate(params, "MnistNet1", x, y)


def test_run_pipeline_structural_columns(monkeypatch):
    """Both pipelines on the same (initial) params for a dense and the
    separable MNIST student: the rows' structural columns (params, bytes,
    rounds, post-Sign bytes, the LAN/WAN model times, the frontier) are
    equal in every mode."""
    def fixed(pkg):
        def train(net, data, **kw):
            p = _ref_params(net)
            p = params_from_numpy(p) if pkg is kd else p
            return pkg.TrainResult(p, [(0, 1.0, 0.5)],
                                   pkg.bnn.param_count(p))
        return train
    family = {"mnist": {**pipeline.FAMILIES["mnist"], "students": [
        ("MnistNet1", "dense"), ("MnistNet3-sep", "separable")]}}
    for pipe, pkg in ((pipeline, kd), (jpipe, jkd)):
        monkeypatch.setattr(pipe, "train_bnn", fixed(pkg))
        monkeypatch.setattr(pipe, "FAMILIES", family)
    kw = dict(families=("mnist",), secure_eval_size=0, verbose=False)
    got = pipeline.run_pipeline(device="cpu", **kw)["rows"]
    want = jpipe.run_pipeline(**kw)["rows"]
    assert len(got) == len(want) == 6
    assert got == want


def test_distill_cli_writes_only_out(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "FAMILIES", {"mnist": {
        **pipeline.FAMILIES["mnist"], "students": [("MnistNet1", "dense")]}})
    monkeypatch.setattr(distill_cli, "run_pipeline", functools.partial(
        pipeline.run_pipeline, families=("mnist",)))
    res = distill_cli.main(["--quick", "--device", "cpu"])
    assert [r["mode"] for r in res["rows"]] == ["shared", "arith", "public"]
    assert list(tmp_path.iterdir()) == []          # nothing written
    out = tmp_path / "rows.json"
    distill_cli.main(["--quick", "--device", "cpu", "--out", str(out)])
    assert list(tmp_path.iterdir()) == [out]
    rows = json.loads(out.read_text())["rows"]
    assert rows == res["rows"]       # the same seeds give the same rows
    assert rows[0]["params"] == 119_306 and rows[0]["online_kb"] == 10.992
    assert rows[0]["secure_acc"] is not None and rows[1]["secure_acc"] is None
