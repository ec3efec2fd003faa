"""The port's kernel autotuner (DESIGN.md §15): cache keys, the JSON round
trip, a corrupt cache read as cold, the candidate spaces, dedup in
``ensure_tuned``, and a ``kcfg`` taken from a cache that leaves the logits
bit-identical.  The reference's contract (tests/test_autotune.py) with the
CUDA kernels' launch choices in place of Pallas block sizes; the timing of
real candidates on the card is in the ``cuda`` cases at the end."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, prf, secure_model
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.kernels import autotune, limbs
from repro_torch.kernels.lowering import (DEFAULT_CONFIG, PLAIN, KernelConfig,
                                          plan_config, resolve)
from repro_torch.nn import bnn

torch.set_num_threads(1)
SMS = 132   # the H100 SXM's SMs: the card's spaces, built on the host


def test_cache_key_padding():
    # dense: every dim padded to 128, as the kernels pad their limb caches
    assert autotune.cache_key("rss_matmul", 8, 784, 10, device="cpu") == \
        "rss_matmul.m128k896n128.L4.cpu"
    assert autotune.cache_key("rss_matmul", 128, 896, 128, device="cpu") \
        == autotune.cache_key("rss_matmul", 8, 784, 10, device="cpu")
    assert autotune.cache_key("bin_rss_matmul", 32, 3136, 512, n_limbs=2,
                              device="cpu") == \
        "bin_rss_matmul.m128k3200n512.L2.cpu"
    # grouped: only M padded, channels in the key
    assert autotune.cache_key("grouped_rss_matmul", 100, 9, 1, channels=16,
                              device="cpu") == \
        "grouped_rss_matmul.m128k9n1.c16.L4.cpu"
    # the default device: the card where there is one, else the CPU
    name = (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")
    assert autotune.device_name() == name
    assert autotune.cache_key("rss_matmul", 8, 8, 8).endswith("." + name)
    with pytest.raises(ValueError, match="unknown kernel family"):
        autotune.cache_key("not_a_family", 8, 8, 8)


def test_cache_roundtrip(tmp_path):
    p = tmp_path / "cache.json"
    assert autotune.load_cache(p, refresh=True) == {}
    assert autotune.lookup("rss_matmul", 8, 8, 8, path=p) is None
    key = autotune.cache_key("rss_matmul", 8, 8, 8, device="cpu")
    card = key[:-len("cpu")] + "NVIDIA H100 80GB HBM3"
    autotune._save_cache({key: {"route": limbs.TENSOR_CORE, "splits": 4,
                                "bn": None, "us": 1.0, "default_us": 2.0,
                                "space": "smoke"},
                          card: {"route": limbs.CUDA_CORE, "splits": 1,
                                 "bn": None, "us": 1.0, "default_us": 1.5,
                                 "space": "smoke"}}, p)
    data = json.loads(p.read_text())
    assert data["version"] == autotune.CACHE_VERSION
    cfg = autotune.lookup("rss_matmul", 8, 8, 8, path=p, device="cpu")
    assert cfg == KernelConfig(limbs.TENSOR_CORE, 4, None)
    # the padded key: one entry covers every shape of the same launch
    assert autotune.lookup("rss_matmul", 100, 100, 100, path=p,
                           device="cpu") == cfg
    assert autotune.lookup("rss_matmul", 256, 8, 8, path=p,
                           device="cpu") is None
    # keyed by device: a card's entry is not the host's
    assert autotune.load_cache(p)[card]["route"] == limbs.CUDA_CORE
    assert autotune.load_cache(p, refresh=True)[key]["us"] == 1.0


def test_corrupt_cache_is_cold_not_fatal(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text("{not json")
    assert autotune.load_cache(p, refresh=True) == {}
    assert autotune.lookup("rss_matmul", 8, 8, 8, path=p) is None
    p.write_bytes(b"\xff\xfe\x00")
    assert autotune.load_cache(p, refresh=True) == {}


def test_candidate_space_on_the_host_is_the_plain_version():
    for fam in autotune.FAMILIES:
        assert autotune.candidate_space(fam, 64, 64, 64, device="cpu") == \
            [KernelConfig(route=PLAIN)]


@pytest.mark.parametrize("family", ["rss_matmul", "bin_rss_matmul"])
@pytest.mark.parametrize("m,k,n", [(32, 3136, 512), (25088, 25, 32),
                                   (2048, 9, 32), (6272, 800, 64),
                                   (32, 512, 10)])
def test_candidate_space_on_the_card(family, m, k, n):
    """The card's space (built here from the plan, no card needed): the
    plan first, never the plain version, every config distinct; smoke
    bounded and inside the full space."""
    smoke = autotune.candidate_space(family, m, k, n, smoke=True,
                                     device="cuda", sms=SMS)
    full = autotune.candidate_space(family, m, k, n, device="cuda",
                                    sms=SMS)
    plan = plan_config(family, 3, m, k, n, SMS)
    assert smoke[0] == full[0] == plan
    for space in (smoke, full):
        assert all(c.route in (limbs.TENSOR_CORE, limbs.CUDA_CORE)
                   for c in space)
        assert len(space) == len(set(space))
    assert len(smoke) <= 5 and set(smoke) <= set(full)
    # both routes are always measured
    assert {c.route for c in smoke} == {limbs.TENSOR_CORE, limbs.CUDA_CORE}
    if family == "bin_rss_matmul":
        assert {c.bn for c in full if c.route == limbs.CUDA_CORE} == \
            {16, 32, 64}
    # each config resolves to the launch it names
    steps = -(-k // limbs.K_STAGE)
    for c in full:
        route, per, bn = resolve(c, 3, m, k, n, SMS, family)
        assert route == c.route and (bn or None) == c.bn
        assert -(-steps // per) == c.splits


def test_grouped_space_is_one_kernel():
    for fam in ("grouped_rss_matmul", "bin_grouped_matmul"):
        assert autotune.candidate_space(fam, 1024, 9, 1, device="cuda",
                                        sms=SMS) == [DEFAULT_CONFIG]


def test_resolve_follows_the_plan_and_refuses_the_plain_version():
    plan = limbs.limb_mma_plan(3, 32, 3136, 512, SMS)
    assert resolve(None, 3, 32, 3136, 512, SMS, "rss_matmul") == \
        (plan[0], plan[1], 0)
    assert resolve(DEFAULT_CONFIG, 3, 32, 3136, 512, SMS, "rss_matmul") == \
        (plan[0], plan[1], 0)
    with pytest.raises(ValueError, match="plain version"):
        resolve(KernelConfig(route=PLAIN), 3, 32, 64, 64, SMS, "rss_matmul")
    with pytest.raises(ValueError, match="bn=32"):
        resolve(KernelConfig(limbs.CUDA_CORE, 1, 32), 3, 32, 64, 64, SMS,
                "rss_matmul")
    assert resolve(KernelConfig(limbs.CUDA_CORE, 1, 32), 3, 32, 64, 64, SMS,
                   "bin_rss_matmul") == (limbs.CUDA_CORE, 2, 32)
    # the plan's config is what DEFAULT_CONFIG runs
    cfg = plan_config("rss_matmul", 3, 32, 3136, 512, SMS)
    assert resolve(cfg, 3, 32, 3136, 512, SMS, "rss_matmul")[:2] == plan[:2]


def test_autotune_smoke_persists_and_rehits(tmp_path):
    p = tmp_path / "cache.json"
    best, timings = autotune.autotune("rss_matmul", 8, 8, 8, iters=1,
                                      smoke=True, cache_path=p, device="cpu")
    assert best == KernelConfig(route=PLAIN) and list(timings) == [best]
    entry = json.loads(p.read_text())["entries"][
        autotune.cache_key("rss_matmul", 8, 8, 8, device="cpu")]
    assert entry["route"] == PLAIN and entry["us"] == entry["default_us"]
    before = p.read_text()
    best2, _ = autotune.autotune("rss_matmul", 8, 8, 8, iters=1, smoke=True,
                                 cache_path=p, device="cpu")
    assert best2 == best and p.read_text() == before


def test_ensure_tuned_dedups_and_skips_hits(tmp_path):
    p = tmp_path / "cache.json"
    reqs = [("rss_matmul", 8, 8, 8, 4, None),
            ("rss_matmul", 100, 100, 100, 4, None),   # same padded launch
            ("grouped_rss_matmul", 50, 9, 1, 4, 4),
            ("grouped_rss_matmul", 60, 9, 1, 4, 4)]
    assert autotune.ensure_tuned(reqs, iters=1, cache_path=p,
                                 device="cpu") == 2
    assert autotune.ensure_tuned(reqs, iters=1, cache_path=p,
                                 device="cpu") == 0
    assert len(autotune.load_cache(p)) == 2


def _compile(params, net, **kw):
    return secure_model.compile_secure(params, net, prf.PRNGKey(1), RING32,
                                       device="cpu", **kw)


@pytest.mark.parametrize("weights", ["shared", "public"])
def test_kcfg_from_cache_is_bit_identical(tmp_path, weights):
    """A compile that pins configs from a cache carries them on each op,
    in the op's part order, and opens the same logits bit for bit."""
    net, batch = "MnistNet3-sep", 4
    params = bnn.init_bnn(0, net)
    plain = _compile(params, net, weights=weights,
                     autotune_cache=tmp_path / "empty.json")
    assert not any("kcfg" in op for op in plain.ops)
    reqs = cost_model.model_cost(
        plain, (batch,) + bnn.INPUT_SHAPES[net]).kernel_requests()
    cache = tmp_path / "autotune.json"
    autotune.ensure_tuned(reqs, iters=1, cache_path=cache, device="cpu")
    tuned = _compile(params, net, weights=weights, autotune_cache=cache,
                     deployment=cost_model.LAN.with_batch(batch))
    for op in tuned.ops:
        if op["op"] in ("conv", "sepconv", "fc"):
            parts = op["w"] if weights == "shared" else op["pub_w"]
            assert op["kcfg"] == [KernelConfig(route=PLAIN)] * len(parts)
    x = np.random.default_rng(0).integers(
        0, 2, (batch,) + bnn.INPUT_SHAPES[net]).astype(np.float32) - 0.5
    xs = share(torch.from_numpy(x), prf.PRNGKey(3), RING32)
    parties = Parties.setup(prf.PRNGKey(7))
    out = [secure_model.secure_infer(m, xs, parties) for m in (plain, tuned)]
    assert torch.equal(out[0], out[1])


def test_card_configs_leave_host_logits_unchanged():
    """On CPU tensors every wrapper runs the plain version: configs of
    the card's launches (any route, split or width) change nothing."""
    net, batch = "MnistNet1", 2
    params = bnn.init_bnn(0, net)
    plain = _compile(params, net, weights="public")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (batch,) + bnn.INPUT_SHAPES[net]).astype(np.float32) - 0.5)
    xs = share(x, prf.PRNGKey(3), RING32)
    parties = Parties.setup(prf.PRNGKey(7))
    want = secure_model.secure_infer(plain, xs, parties)
    for cfg in (KernelConfig(limbs.TENSOR_CORE, 7),
                KernelConfig(limbs.CUDA_CORE, 1, 16)):
        for op in plain.ops:
            if op["op"] == "fc":
                op["kcfg"] = [cfg]
        assert torch.equal(secure_model.secure_infer(plain, xs, parties),
                           want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family,m,k,n,limbs_", [
    ("rss_matmul", 32, 3136, 512, 4), ("rss_matmul", 2048, 9, 32, 4),
    ("bin_rss_matmul", 32, 3136, 512, 2), ("bin_rss_matmul", 2048, 9, 32, 2),
    ("grouped_rss_matmul", 2048, 9, 1, 4)])
def test_autotune_times_kernels_on_the_card(cuda, tmp_path, family, m, k, n,
                                            limbs_):
    """On the card every candidate is a kernel launch, equal to the plan's
    bit for bit (``autotune`` checks), timed with CUDA events."""
    from repro_torch.kernels import build as kbuild
    ch = 8 if "grouped" in family else None
    before = dict(kbuild.LAUNCHES)
    best, timings = autotune.autotune(family, m, k, n, n_limbs=limbs_,
                                      channels=ch, smoke=True, iters=5,
                                      cache_path=tmp_path / "c.json",
                                      device=cuda)
    assert PLAIN not in {c.route for c in timings}
    assert best in timings and all(t > 0 for t in timings.values())
    assert kbuild.LAUNCHES[family] > before[family]
    key = autotune.cache_key(family, m, k, n, n_limbs=limbs_, channels=ch,
                             device=cuda)
    assert key.endswith(torch.cuda.get_device_name(cuda))
