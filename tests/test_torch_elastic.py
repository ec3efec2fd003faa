"""Elastic reshape on the port: a checkpoint written by the trainer on one
device mesh restores onto another (the recover-without-the-sick-host
path of the reference's ``tests/test_elastic.py``), and the sharded
trainer agrees with the single-device one.

Four gloo CPU ranks (one ``PartyGroup`` for the module) train the reduced
TinyLlama for 4 steps on a (2, 2) ("data", "model") mesh: parameters as
DTensors by ``param_specs``, AdamW moments by ``opt_specs``, each rank
its data shard of the batch.  Held against the single-device trainer at
the reference test's rtol / atol 2e-4 (parameters) and 2e-3 (loss): the
mesh sums the gradient over ranks in another order.  Then a (1, 4) mesh
restores the checkpoint, through the trainer's resume and through
``restore_checkpoint(..., shardings=)``: the values equal the trained
ones exactly and the leaves live in the new layout.
"""
import numpy as np
import pytest
import torch

import torch_launch_ranks as tasks
from repro_torch.configs import get_config
from repro_torch.core.party_group import PartyGroup
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.weights import lm_tree

torch.set_num_threads(1)

CFG = get_config("tinyllama-1.1b").reduced()


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=240, ranks=4) as g:
        yield g


def _tcfg(ck, steps=4):
    return TrainerConfig(steps=steps, global_batch=4, seq_len=32,
                         ckpt_dir=str(ck), ckpt_every=4, log_every=100)


def _single(ck, steps=4, opt_cfg=None):
    params, _, metrics = Trainer(CFG, _tcfg(ck, steps), opt_cfg,
                                 device="cpu").run(resume=False)
    return dict(params.named_parameters()), metrics


def test_mesh_trainer_matches_single_device(group, tmp_path):
    whole, place, m_place, metrics = group.run(
        tasks.train, (CFG, _tcfg(tmp_path / "mesh"), (2, 2)))[0]
    ref, ref_metrics = _single(tmp_path / "one")
    for k, v in ref.items():
        np.testing.assert_allclose(whole[k].numpy(), v.detach().numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    assert [m["step"] for m in metrics] == [0, 1, 2, 3]
    for a, b in zip(metrics, ref_metrics):
        assert abs(a["loss"] - b["loss"]) < 2e-3, (a, b)
    # FSDP x TP storage: wq (d, d) over ("data", "model"), the moments too
    d = CFG.d_model
    assert place["layers.0.attn.wq"] == ("(Shard(dim=0), Shard(dim=1))",
                                         (d // 2, d // 2))
    assert place["embed"][0] == "(Shard(dim=1), Shard(dim=0))"
    assert m_place == place["embed"][0]


def test_int8_moments_follow_opt_specs(group, tmp_path):
    """ZeRO-1 with int8 moments: the payload in the parameter's layout,
    the per-row scales without its last axis (embed's rows over "model",
    its last axis, over "data", dropped).  The values are not held to the
    single-device run: a uint8 second moment that rounds to 0 under one
    summation order and not the other moves an element by lr / eps."""
    opt_cfg = OptConfig(state_dtype="int8")
    _, place, m_place, metrics = group.run(
        tasks.train, (CFG, _tcfg(tmp_path / "mesh", 2), (2, 2), opt_cfg))[0]
    _, ref_metrics = _single(tmp_path / "one", 2, opt_cfg)
    assert m_place == {"q8": place["embed"][0],
                       "s8": "(Replicate(), Shard(dim=0))"}
    assert abs(metrics[0]["loss"] - ref_metrics[0]["loss"]) < 2e-3
    assert all(np.isfinite(m["loss"]) for m in metrics)


def test_checkpoint_restores_onto_another_mesh(group, tmp_path):
    ck = tmp_path / "ck"
    trained, place_a, _, _ = group.run(tasks.train,
                                       (CFG, _tcfg(ck), (2, 2)))[0]
    # the trainer on a (1, 4) mesh resumes at step 4: no step left to run
    restored, place_b, _, metrics = group.run(tasks.train,
                                              (CFG, _tcfg(ck), (1, 4)))[0]
    assert metrics == []
    for k, v in trained.items():
        assert torch.equal(restored[k], v), k
    d = CFG.d_model
    assert place_a["layers.0.attn.wq"][1] == (d // 2, d // 2)
    assert place_b["layers.0.attn.wq"][1] == (d, d // 4)
    # restore_checkpoint(shardings=) in the reference's stacked layout
    leaves, placed, step = group.run(tasks.restore_onto,
                                     (str(ck), CFG, (1, 4)))[0]
    assert step == 4
    want = lm_tree(trained, CFG)

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield ".".join(path + (k,)), v
    flat = dict(walk(want))
    assert set(flat) == set(leaves)
    for k, v in flat.items():
        np.testing.assert_array_equal(leaves[k].numpy(), v, err_msg=k)
    assert placed["group0.attn.wq"] == ("(Shard(dim=1), Shard(dim=2))",
                                        (CFG.n_layers, d, d // 4))
