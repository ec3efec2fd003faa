"""The plain reference: its BN folds are the model owner's, its logits are
the system's secure logits on the CPU, its bfloat16 control is not, and it
loads nothing of the system."""
import json
import subprocess
import sys

import pytest
import torch

from cbnn_bench.harness import check, inputs, manifest
from cbnn_bench.reference import forward as ref


def _cfg(name):
    with open(manifest.ROOT / "cbnn_bench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _setup(name, batch=2, distinct=2, seed=11):
    cfg = _cfg(name)
    images = inputs.make_images(cfg, batch, distinct, seed, "cpu")
    params = inputs.make_params(cfg, seed, "cpu", images.flatten(0, 1))
    return cfg, images, params


@pytest.mark.parametrize("name", ["cifarnet2", "cifarnet7"])
def test_folds_are_the_model_owners(name):
    from repro_torch.core.norm import fuse_bn_linear, fuse_bn_sign_threshold
    cfg, _, params = _setup(name)
    ops = ref.fold(params, cfg["layers"], cfg["ring"]["frac"], cfg["bn_eps"])
    lin = [i for i, l in enumerate(cfg["layers"])
           if l["kind"] in ("conv", "sepconv", "fc")]
    frac = cfg["ring"]["frac"]
    for i, op in zip(lin, [o for o in ops if "w" in o]):
        if cfg["layers"][i + 1]["kind"] != "bn" \
                if i + 1 < len(cfg["layers"]) else True:
            continue
        bn = [params[f"l{i + 1}_{k}"].numpy()
              for k in ("g", "beta", "mu", "var")]
        if op["t"] is not None:
            t = fuse_bn_sign_threshold(*bn)
            assert torch.equal(op["t"], ref._enc(torch.from_numpy(t), frac))
        else:
            last = "pw" if cfg["layers"][i]["kind"] == "sepconv" else "w"
            w, b = fuse_bn_linear(params[f"l{i}_{last}"].numpy(),
                                  params[f"l{i}_b"].numpy(), *bn)
            assert torch.equal(op["w"][-1], ref._enc(torch.from_numpy(w),
                                                     frac))
            assert torch.equal(op["b"], ref._enc(torch.from_numpy(b), frac))
    assert any(o.get("t") is not None for o in ops) == (name == "cifarnet2")


@pytest.mark.parametrize("weights", ["shared", "public"])
def test_secure_logits_equal_reference(weights):
    """CifarNet2 at batch 2 on the CPU: the secure logits are the
    reference's exactly (its limit), on two image batches and two key
    sets."""
    from repro_torch.core import prf
    from repro_torch.core.ring import RING32
    from repro_torch.core.rss import share
    from repro_torch.launch import serve_secure
    cfg, images, params = _setup("cifarnet2")
    model = serve_secure.build(cfg["net"], device="cpu", params=params,
                               weights=weights)
    run = serve_secure.make_runner(model)
    refs = check.reference_logits(cfg, params, images)
    answers = []
    for q in range(2):
        xs = share(images[q], prf.PRNGKey(40 + q), RING32)
        answers.append((q, run(prf.split(prf.PRNGKey(50 + q), 3),
                               xs.shares).float()))
    checks, failed = check.compare(cfg, answers, refs)
    assert failed == 0 and checks["logit_gap"]["value"] == 0.0


def test_bfloat16_control_fails():
    """The reference in bfloat16 put in the system's place is not correct
    (the control, at a test's size)."""
    cfg, images, params = _setup("cifarnet2", batch=4)
    refs = check.reference_logits(cfg, params, images)
    ctrl = check.reference_logits(cfg, params, images, torch.bfloat16)
    checks, failed = check.compare(cfg, list(enumerate(ctrl)), refs)
    assert failed > 0 and checks["logit_gap"]["value"] > 0.01


def test_compare_flags_a_wrong_answer():
    cfg = _cfg("cifarnet2")
    refs = [torch.zeros(2, 10), torch.ones(2, 10)]
    good = [(0, torch.zeros(2, 10)), (1, torch.ones(2, 10))]
    assert check.compare(cfg, good, refs)[1] == 0
    for bad in ([(0, torch.ones(2, 10))], [(1, torch.ones(1, 10))],
                [(1, torch.full((2, 10), float("nan")))], []):
        assert check.compare(cfg, bad, refs)[1] > 0


def test_grid_margin_holds():
    """Every Sign input of a grid configuration lies at least half a grid
    step (8 units of 2^-frac) from its threshold in the reference: wider
    than the truncation's error."""
    cfg, images, params = _setup("cifarnet2", batch=4)
    frac = cfg["ring"]["frac"]
    ops = ref.fold(params, cfg["layers"], frac, cfg["bn_eps"])
    margins = []
    for k, op in enumerate(ops):
        if op.get("t") is not None:
            z = ref.forward(ops[:k] + [dict(op, t=None)], images[0], frac)
            margins.append(float((z.double() + op["t"].double()).abs().min())
                           * (1 << frac))
    assert len(margins) == 9 and min(margins) >= 8


def test_reference_loads_nothing_of_the_system():
    code = ("import sys; sys.path.insert(0, %r); "
            "import cbnn_bench.reference.forward, cbnn_bench.counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
