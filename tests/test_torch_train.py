"""The port's LM training path against the JAX package: ``loss_fn`` and its
gradient, one ``make_train_step`` (reduced TinyLlama-1.1B and Mamba2-1.3B
from the reference's initial weights), the checkpoints (round trip,
retention, the invisible partial write, the shape check, and a checkpoint
of either package restored by the other), and the trainer (crash and
resume, the loss falling, the launcher).

Tolerances.  The LM computes in bf16 on both sides, and their bf16
roundings differ by an ulp here and there (tests/test_torch_lm.py):
* loss within 1e-3 of its value (measured 1.0e-4 on TinyLlama, 6e-7 on
  Mamba2), the gradient norm within 1e-2 (measured 6.2e-4);
* each gradient leaf and AdamW first moment within 4% relative L2
  (measured worst: 2.1% on TinyLlama, at layer 3's wq, whose gradient
  passes four layers of bf16 cotangents; 0.55% on Mamba2);
* each parameter's move in the step, p_new - p_old, within 1e-6 of the
  reference's wherever the reference's gradient exceeds 0.3 x its leaf's
  RMS (54% of TinyLlama's elements, 58% of Mamba2's; measured 1.0e-7 and
  3.0e-8): the first AdamW step moves an element by lr·(±1 + wd·p) along
  the sign of its gradient, so this pins lr, the warm-up, the weight
  decay and the sign.  Below that threshold the gradient may sit at the
  bf16 rounding level and change sign between the two, so those elements
  are held to 2·lr + 1e-6 (measured 6.0e-4 = 2·lr at most; at 0.1 x RMS
  a sign still flips nowhere, at 0.03 x RMS 28 do).
Checkpoints carry float32 arrays exactly.  Crash and resume are held to
the reference test's own tolerance (rtol/atol 2e-4, loss 2e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as jsteps
from repro.nn import transformer as jtfm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.train import restore_checkpoint as jrestore
from repro.train import save_checkpoint as jsave
from repro_torch.configs import get_config
from repro_torch.data import token_stream
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.nn import transformer as tfm
from repro_torch.nn.layers import trainable
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import (Trainer, TrainerConfig, latest_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.weights import (lm_flat, lm_params_from_numpy,
                                 lm_params_to_numpy)

torch.set_num_threads(1)

ARCHS = ["tinyllama-1.1b", "mamba2-1.3b"]
LOSS_REL, NORM_REL, GRAD_REL = 1e-3, 1e-2, 0.04
MOVE_TOL, NOISE_RMS = 1e-6, 0.3


def _cfgs(arch):
    return ref_config(arch).reduced(), get_config(arch).reduced()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# -- loss and one train step -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grad_and_train_step_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    batch, _ = next(token_stream(2, 32, jcfg.vocab, seed=1))
    ocfg = dict(warmup_steps=2)
    jp2, jo2, jm = jax.jit(jsteps.make_train_step(jcfg, JOptConfig(**ocfg)))(
        jp, jadamw_init(jp), batch)
    jloss, jnorm = float(jm["loss"]), float(jm["grad_norm"])
    # the reference's gradient from its first moment: m = (1 - b1) g clip
    clip = min(1.0, 1.0 / (jnorm + 1e-9))
    jm_flat = lm_flat(_np_tree(jo2["m"]), cfg)
    jgrad = {k: v / (0.1 * clip) for k, v in jm_flat.items()}

    model = lm_params_from_numpy(_np_tree(jp), cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in named.items()}
    with trainable(model) as leaves:
        loss = tfm.loss_fn(model, tb, cfg)
        grads = torch.autograd.grad(loss, leaves)
    assert not any(p.requires_grad for p in model.parameters())
    assert abs(float(loss.detach()) - jloss) <= LOSS_REL * abs(jloss)
    for k, g in zip(named, grads):
        assert _rel_l2(g.numpy(), jgrad[k]) <= GRAD_REL, k

    step = steps.make_train_step(cfg, OptConfig(**ocfg))
    model, opt, m = step(model, adamw_init(named), tb)
    assert abs(float(m["loss"]) - jloss) <= LOSS_REL * abs(jloss)
    assert abs(float(m["grad_norm"]) - jnorm) <= NORM_REL * jnorm
    assert int(opt["step"]) == 1
    lr = OptConfig(**ocfg).lr
    old, new = lm_flat(_np_tree(jp), cfg), lm_flat(_np_tree(jp2), cfg)
    for k, p in model.named_parameters():
        assert _rel_l2(opt["m"][k].numpy(), jm_flat[k]) <= GRAD_REL, k
        d = np.abs((p.detach().numpy() - old[k]) - (new[k] - old[k]))
        g = np.abs(jgrad[k])
        firm = g > NOISE_RMS * np.sqrt(np.mean(g * g))
        assert firm.any() and d[firm].max() <= MOVE_TOL, k
        assert d.max() <= 2 * lr + 1e-6, k
        assert not torch.equal(p, before[k]), k     # every leaf moved


def test_loss_fn_masks_negative_labels():
    cfg = get_config("tinyllama-1.1b").reduced()
    model = tfm.init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator()
                         .manual_seed(0))
    labels = toks.roll(-1, 1)
    full = tfm.loss_fn(model, {"tokens": toks, "labels": labels}, cfg)
    half = labels.clone()
    half[:, 4:] = -1
    masked = tfm.loss_fn(model, {"tokens": toks, "labels": half}, cfg)
    logits = tfm.forward(model, {"tokens": toks}, cfg).float()
    want = torch.nn.functional.cross_entropy(
        logits[:, :4].reshape(-1, cfg.vocab), labels[:, :4].reshape(-1))
    assert torch.allclose(masked, want, atol=1e-5) and masked != full


# -- checkpoints -------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12, dtype=torch.float32)
                        .reshape(3, 4)},
             "opt": {"m": torch.zeros(3, 4),
                     "step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(tmp_path, 7, state, extra={"cursor": 7})
    got, step, extra = restore_checkpoint(tmp_path, state)
    assert step == 7 and extra["cursor"] == 7
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    assert restore_checkpoint(tmp_path / "none", state) == (None, None, None)


def test_retention_keeps_last_n(tmp_path):
    state = {"x": np.zeros(3, np.float32)}
    for s in (10, 20, 30, 40):
        save_checkpoint(tmp_path, s, state, keep=2)
    steps_ = sorted(p.name for p in tmp_path.iterdir()
                    if p.name.startswith("step-"))
    assert steps_ == ["step-000000030", "step-000000040"]


def test_partial_write_is_invisible(tmp_path):
    """A crash mid-write (tmp dir left behind) must not corrupt restore."""
    state = {"x": np.ones(3, np.float32)}
    save_checkpoint(tmp_path, 5, state)
    bad = tmp_path / "tmp-6-9999"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    half = tmp_path / "step-000000006"      # renamed, manifest never written
    half.mkdir()
    assert latest_step(tmp_path) == 5
    got, step, _ = restore_checkpoint(tmp_path, state)
    assert step == 5 and np.array_equal(got["x"], state["x"])


def test_changed_structure_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(8, 4)})


def _ref_state(jcfg):
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    opt = jadamw_init(jp)
    opt = {"m": jax.tree.map(lambda p: 0.5 * p, jp),
           "v": jax.tree.map(lambda p: p * p, jp),
           "step": jnp.asarray(3, jnp.int32)}
    return {"params": jp, "opt": opt}


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(arch, tmp_path):
    """A checkpoint the reference writes restores in the port's trainer,
    and one the port's trainer writes restores in the reference."""
    jcfg, cfg = _cfgs(arch)
    ref = _ref_state(jcfg)
    jsave(tmp_path / "ref", 3, ref, extra={"data_cursor": 3})
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "ref")),
                 device="cpu")
    params, opt, step = tr._restore(*tr.init_state())
    assert step == 3 and int(opt["step"]) == 3
    want = lm_flat(_np_tree(ref["params"]), cfg)
    for k, p in params.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[k]), k
        assert np.array_equal(opt["m"][k].numpy(), 0.5 * want[k]), k
        assert np.array_equal(opt["v"][k].numpy(), want[k] * want[k]), k

    # the other way: the port's state, through the reference's restore
    opt["step"] = torch.tensor(9, dtype=torch.int32)
    save_checkpoint(tmp_path / "port", 9, tr._tree(params, opt))
    got, step, _ = jrestore(tmp_path / "port",
                            jax.eval_shape(lambda: _ref_state(jcfg)))
    assert step == 9 and int(got["opt"]["step"]) == 9
    mine = lm_params_to_numpy(params, cfg)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got["params"])[0],
            jax.tree.leaves(mine)):
        assert np.array_equal(np.asarray(a), b), path
    assert jax.tree.structure(got["params"]) == jax.tree.structure(mine)


# -- the trainer -------------------------------------------------------------

def test_crash_resume_matches_uninterrupted(tmp_path):
    """Train 6 steps; crash at 4 and resume; the final params match an
    uninterrupted run (deterministic data stream + optimizer)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    tc = dict(steps=6, global_batch=2, seq_len=16, ckpt_every=2,
              log_every=100)
    t_ref = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tc),
                    device="cpu")
    p_ref, _, m_ref = t_ref.run(resume=False)

    t_a = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "ab"), **tc),
                  device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        t_a.run(resume=False, fail_at_step=4)
    assert latest_step(tmp_path / "ab") == 4
    t_b = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "ab"), **tc),
                  device="cpu")
    p_res, _, m_res = t_b.run(resume=True)
    assert [m["step"] for m in m_res] == [4, 5]
    for (k, a), b in zip(p_ref.named_parameters(), p_res.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    ref_tail = [m for m in m_ref if m["step"] >= 4]
    assert len(ref_tail) == len(m_res)
    for a, b in zip(ref_tail, m_res):
        assert abs(a["loss"] - b["loss"]) < 2e-3
    assert (tmp_path / "ab" / "metrics.jsonl").exists()


def test_int8_state_trainer_resumes_and_crosses(tmp_path):
    """A trainer with int8 / uint8 moments: its state starts quantized, a
    crash at step 2 and a resume match an uninterrupted run bit for bit
    (codes and scales included), and its checkpoint restores in the
    reference under the reference's int8 state layout."""
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    ocfg = OptConfig(warmup_steps=3, state_dtype="int8")
    tc = dict(steps=3, global_batch=2, seq_len=16, ckpt_every=1,
              log_every=100)

    def trainer(name):
        return Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / name),
                                          **tc), opt_cfg=ocfg, device="cpu")
    p_ref, o_ref, _ = trainer("ref").run(resume=False)
    assert o_ref["m"]["embed"]["q8"].dtype == torch.int8
    assert o_ref["v"]["embed"]["qu8"].dtype == torch.uint8
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer("ab").run(resume=False, fail_at_step=2)
    p_res, o_res, m_res = trainer("ab").run(resume=True)
    assert [m["step"] for m in m_res] == [2]
    for (k, a), b in zip(p_ref.named_parameters(), p_res.parameters()):
        assert torch.equal(a, b), k
        for mom in ("m", "v"):
            for q, t in o_ref[mom][k].items():
                assert torch.equal(t, o_res[mom][k][q]), (k, mom, q)

    like = jax.eval_shape(lambda: (lambda p: {"params": p, "opt": jadamw_init(
        p, JOptConfig(state_dtype="int8"))})(
            jtfm.init_params(jax.random.PRNGKey(0), jcfg)))
    got, step, _ = jrestore(tmp_path / "ref", like)
    assert step == 3 and int(got["opt"]["step"]) == 3
    q8 = lm_flat(_np_tree(got["opt"]["m"]), cfg)
    for k in o_ref["m"]:
        for q, t in o_ref["m"][k].items():
            assert np.array_equal(q8[f"{k}.{q}"], t.float().numpy()), (k, q)


def test_training_loss_decreases(tmp_path, monkeypatch):
    """The reference test's 12 steps at warm-up 3, from the reference's
    initial weights (the port's own init draws other bits): the port
    follows the reference's loss curve (within 1e-3 a step on this tree)
    and its last three losses sit below its first three.  From the port's
    own init the same comparison is a coin toss (seeds 0-3: two rise, one
    falls, one is flat): each step sees a fresh batch, and 12 steps at
    lr 3e-4 move the loss less than the batches spread.  What 12 steps do
    show from any init is the loss of a batch already trained on, which
    falls by 0.58-0.73 over seeds 0-3; the test holds that too."""
    cfg = get_config("tinyllama-1.1b").reduced()
    jp = _np_tree(jtfm.init_params(jax.random.PRNGKey(0),
                                   ref_config("tinyllama-1.1b").reduced()))
    monkeypatch.setattr(tfm, "init_params", lambda c, seed, device=None:
                        lm_params_from_numpy(jp, c, device))
    t = Trainer(cfg, TrainerConfig(steps=12, global_batch=4, seq_len=32,
                                   ckpt_dir=str(tmp_path / "l"),
                                   ckpt_every=100, log_every=100),
                opt_cfg=OptConfig(warmup_steps=3), device="cpu")
    _, _, metrics = t.run(resume=False)
    first3 = np.mean([m["loss"] for m in metrics[:3]])
    last3 = np.mean([m["loss"] for m in metrics[-3:]])
    assert last3 < first3, (first3, last3)

    monkeypatch.undo()
    t = Trainer(cfg, TrainerConfig(steps=12, global_batch=4, seq_len=32,
                                   ckpt_dir=str(tmp_path / "own"),
                                   ckpt_every=100, log_every=100),
                opt_cfg=OptConfig(warmup_steps=3), device="cpu")
    params, _ = t.init_state()
    first, _ = next(token_stream(4, 32, cfg.vocab, seed=0))
    first = {k: torch.from_numpy(v) for k, v in first.items()}
    with torch.no_grad():
        before = float(tfm.loss_fn(params, first, cfg))
    trained = t.run(resume=False)[0]
    with torch.no_grad():
        after = float(tfm.loss_fn(trained, first, cfg))
    assert after < before - 0.3, (before, after)


def test_mesh_is_refused_and_launcher_runs(tmp_path, monkeypatch):
    """The production meshes need torchrun's ranks: without them the
    launcher names the count it needs; the host mesh's rank task trains
    on a 4-rank group (the launcher's --mesh host8 runs it on 8) and
    resumes from its own checkpoint; one device runs and resumes."""
    from repro_torch.core.party_group import PartyGroup
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for kind, n in (("single", 256), ("multi", 512)):
        with pytest.raises(RuntimeError, match=f"runs on {n} ranks"):
            train_cli.main(["--arch", "mamba2-1.3b", "--reduced", "--mesh",
                            kind, "--device", "cpu"])
    cfg = get_config("mamba2-1.3b").reduced()
    tc = TrainerConfig(steps=2, global_batch=4, seq_len=16,
                       ckpt_dir=str(tmp_path / "mesh"), ckpt_every=2,
                       log_every=100)
    with PartyGroup("cpu", timeout=60, deadline=120, ranks=4) as g:
        ranks = g.run(train_cli._rank_train, (cfg, tc, (2, 2)))
        assert [m["step"] for m in ranks[0]] == [0, 1]
        losses = [[m["loss"] for m in r] for r in ranks]
        assert all(r == losses[0] for r in losses[1:])
        assert latest_step(tc.ckpt_dir) == 2
        assert g.run(train_cli._rank_train, (cfg, tc, (1, 4)))[0] == []
    ck = tmp_path / "ck"
    metrics = train_cli.main(["--arch", "mamba2-1.3b", "--reduced",
                              "--steps", "2", "--global-batch", "2",
                              "--seq-len", "16", "--ckpt-dir", str(ck),
                              "--device", "cpu"])
    assert [m["step"] for m in metrics] == [0, 1]
    assert latest_step(ck) == 2
    # a second launch resumes at the manifest's cursor: nothing left to do
    again = Trainer(get_config("mamba2-1.3b").reduced(),
                    dataclasses.replace(TrainerConfig(), steps=3,
                                        global_batch=2, seq_len=16,
                                        ckpt_dir=str(ck)), device="cpu")
    assert [m["step"] for m in again.run()[2]] == [2]
