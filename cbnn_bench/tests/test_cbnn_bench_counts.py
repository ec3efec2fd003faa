"""The frozen count (counts.py) against the system's cost model at this
commit: the same int8 work for every net and weight mode, linear in the
batch."""
import json

import pytest
import torch

from cbnn_bench import counts
from cbnn_bench.harness import manifest
from cbnn_bench.reference import forward as ref

# model_cost(...).flops at batch 1 with the system's seed-0 weights
AT_BATCH_1 = {("cifarnet2", "shared"): 265_236_480,
              ("cifarnet2", "public"): 92_832_768,
              ("cifarnet7", "shared"): 34_312_642_560}


def _cfg(name):
    with open(manifest.ROOT / "cbnn_bench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _limbs(cfg, params):
    frac = cfg["ring"]["frac"]
    return [tuple(ref.min_public_limbs(w, frac) for w in op["w"])
            for op in ref.fold(params, cfg["layers"], frac, cfg["bn_eps"])
            if op["kind"] in ("conv", "sepconv", "fc")]


@pytest.mark.parametrize("name,weights", sorted(AT_BATCH_1))
def test_count_matches_cost_model(name, weights):
    from repro_torch.core import cost_model
    from repro_torch.launch import serve_secure
    from repro_torch.nn.bnn import init_bnn
    cfg = _cfg(name)
    params = init_bnn(0, cfg["net"])
    model = serve_secure.build(cfg["net"], device="cpu", params=params,
                               weights=weights)
    limbs = _limbs(cfg, params) if weights == "public" else None
    for batch in (1, 3):
        want = cost_model.model_cost(
            model, (batch, *cfg["input_shape"])).flops
        got = counts.query_ops(counts.launches(
            cfg["layers"], cfg["input_shape"], batch, limbs))
        assert got == want
    assert counts.query_ops(counts.launches(
        cfg["layers"], cfg["input_shape"], 1, limbs)) == AT_BATCH_1[
            (name, weights)]


def test_public_count_on_generated_weights():
    """The harness's own grid weights: the limbs the reference reckons are
    the ones the compiled public model runs."""
    from repro_torch.core import cost_model
    from repro_torch.launch import serve_secure
    from cbnn_bench.harness import inputs
    cfg = _cfg("cifarnet2")
    images = inputs.make_images(cfg, 2, 2, 5, "cpu")
    params = inputs.make_params(cfg, 5, "cpu", images.flatten(0, 1))
    model = serve_secure.build(cfg["net"], device="cpu", params=params,
                               weights="public")
    want = cost_model.model_cost(model, (4, *cfg["input_shape"])).flops
    got = counts.query_ops(counts.launches(
        cfg["layers"], cfg["input_shape"], 4, _limbs(cfg, params)))
    assert got == want


def test_bytes_and_bound():
    """A dense shared launch counts each input and output word once, a
    convolution's input as its activation before the patches are expanded;
    the bound is the larger of its two floors."""
    (x,) = [l for l in counts.launches(
        [{"kind": "fc", "out": 10}], (1, 1, 768), 256)]
    s, m, k, n = 3, 256, 768, 10
    assert x["bytes"] == 4 * (s * m * k + 2 * s * k * n + s * m * n)
    assert x["ops"] == 40 * s * m * k * n
    assert counts.bound_s(x) == max(x["bytes"] / 3.35e12,
                                    x["ops"] / 1.979e15)
    (dw, pw) = counts.launches(
        [{"kind": "sepconv", "out": 32, "k": 3, "stride": 1, "pad": 1}],
        (8, 8, 16), 2, [(2, 3)])
    assert (dw["family"], dw["M"], dw["K"], dw["N"], dw["C"]) == \
        ("depthwise", 128, 9, 1, 16)
    assert dw["bytes"] == 4 * 3 * 2 * 8 * 8 * 16 + 16 * 9 * 2 \
        + 4 * 3 * 16 * 128
    assert pw["bytes"] == 4 * 3 * 128 * 16 + 16 * 32 * 3 + 4 * 3 * 128 * 32
    assert pw["ops"] == 2 * 9 * 3 * 128 * 16 * 32
    (cv,) = counts.launches(
        [{"kind": "conv", "out": 64, "k": 3, "stride": 2, "pad": 1}],
        (8, 8, 3), 2)
    assert (cv["M"], cv["K"], cv["N"]) == (2 * 4 * 4, 27, 64)
    assert cv["bytes"] == 4 * (3 * 2 * 8 * 8 * 3 + 2 * 3 * 27 * 64
                               + 3 * 32 * 64)


def test_min_public_limbs():
    """The reference's limb count equals the system's on encodings of
    every size."""
    from repro_torch.core.ring import RING32
    from repro_torch.kernels.bin_rss_matmul import min_public_limbs
    g = torch.Generator().manual_seed(3)
    for scale in (0.001, 0.3, 7.99, 8.0, 300.0, 1e5):
        for sign in (1, -1):
            w = sign * scale * torch.rand(50, generator=g)
            assert ref.min_public_limbs(w, 12) == \
                min_public_limbs(RING32.encode(w)), (scale, sign)
