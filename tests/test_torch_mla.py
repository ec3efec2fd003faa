"""MLA (deepseek v2/v3) against the JAX package: ``mla_prefill``,
``mla_decode`` (naive: the latent cache expanded to per-head K/V) and
``mla_decode_absorbed`` (scores in the latent space), on the reduced
deepseek-v2 and deepseek-v3 configs and on a ``q_lora_rank=0`` variant
(the ``wq`` query), the reference's weights carried across unchanged.

Tolerances.  Each output and both cache tensors within one bf16 rounding
of their scale (2^-7): the two frameworks compute the same bf16
products and float32 softmax, and differ by an ulp of a bf16 value here
and there.  The port-only copies of the reference's ``tests/test_mla.py``
keep its bounds: absorbed against naive decode within 5% of the logits'
scale, decode against prefill within 0.2, on the whole model with MoE off
(top-k routing is discontinuous; the reference's reason).  The layer plan
and caches of the dense -> MoE prefix are checked here too;
``test_torch_zoo.py`` holds the whole deepseek models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn import attention as jattn
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.nn import attention as attn
from repro_torch.nn import moe
from repro_torch.nn import transformer as tfm

torch.set_num_threads(1)

BF16_TOL = 2.0 ** -7
VARIANTS = {"v2": ("deepseek-v2-236b", {}),
            "v3": ("deepseek-v3-671b", {}),
            "v2-wq": ("deepseek-v2-236b", {"q_lora_rank": 0})}
B, S, SMAX = 2, 12, 8


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mla(variant):
    """(port config, reference config, reference MLA params, the port's
    ``MLA`` holding them)."""
    arch, replace = VARIANTS[variant]
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **replace)
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **replace)
    jp = jattn.mla_init(jax.random.PRNGKey(3), rcfg)
    p = attn.MLA(cfg, device="meta")
    p.load_state_dict({k: torch.tensor(_f32(v)) for k, v in jp.items()},
                      strict=True, assign=True)
    return cfg, rcfg, jp, p


def _x(shape, seed):
    """bf16 inputs from numpy, the same values on both sides."""
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return torch.tensor(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_params_are_the_references(variant):
    """The reference's keys, shapes and init distribution (uniform
    ±1/sqrt(d_in)); ``wq`` exactly where there is no query LoRA."""
    cfg, _, jp, _ = _mla(variant)
    own = attn.mla_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in jp.items()}
    assert ("wq" in jp) == (cfg.q_lora_rank == 0)
    w = own.w_dkv
    assert float(w.abs().max()) <= 1 / np.sqrt(cfg.d_model)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_prefill_matches_reference(variant):
    cfg, rcfg, jp, p = _mla(variant)
    x, jx = _x((B, S, cfg.d_model), 0)
    got, (c_kv, k_rope) = attn.mla_prefill(p, x, cfg)
    want, (jc, jk) = jattn.mla_prefill(jp, jx, rcfg)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.bfloat16
    assert c_kv.shape == (B, S, cfg.kv_lora_rank)
    assert k_rope.shape == (B, S, cfg.rope_head_dim)
    assert _rel(got.float(), want.astype(jnp.float32)) <= BF16_TOL
    assert _rel(c_kv.float(), jc.astype(jnp.float32)) <= BF16_TOL
    assert _rel(k_rope.float(), jk.astype(jnp.float32)) <= BF16_TOL


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_decode_matches_reference(variant, absorbed):
    """Six steps from an empty cache: each step's output and both cache
    tensors; the port writes the cache in place and returns it."""
    cfg, rcfg, jp, p = _mla(variant)
    fn, jfn = ((attn.mla_decode_absorbed, jattn.mla_decode_absorbed)
               if absorbed else (attn.mla_decode, jattn.mla_decode))
    cache = {"c_kv": torch.zeros((B, SMAX, cfg.kv_lora_rank),
                                 dtype=torch.bfloat16),
             "k_rope": torch.zeros((B, SMAX, cfg.rope_head_dim),
                                   dtype=torch.bfloat16)}
    jcache = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in cache.items()}
    for pos in range(6):
        x, jx = _x((B, 1, cfg.d_model), 10 + pos)
        got, out_cache = fn(p, x, cache, pos, cfg)
        want, jcache = jfn(jp, jx, jcache, pos, rcfg)
        assert out_cache is cache and got.shape == (B, 1, cfg.d_model)
        assert _rel(got.float(), want.astype(jnp.float32)) <= BF16_TOL
        for k in cache:
            assert _rel(cache[k][:, :pos + 1].float(),
                        jcache[k][:, :pos + 1].astype(jnp.float32)) \
                <= BF16_TOL
            assert not cache[k][:, pos + 1:].any()


# -- the dense -> MoE prefix ---------------------------------------------------

@pytest.mark.parametrize("arch,dense", [("deepseek-v2-236b", 1),
                                        ("deepseek-v3-671b", 3)])
def test_mla_layer_plan_and_caches(arch, dense):
    """``dense_layers`` MLA + MLP layers, then MLA + MoE layers whose
    shared MLP is e_ff · n_shared wide; latent caches; the MTP head's
    parameters exactly on v3."""
    full = configs.get_config(arch)
    assert tfm.layer_groups(full) == [
        tfm.Group("mla_dense", dense),
        tfm.Group("mla_moe", full.n_layers - dense)]
    cfg = full.reduced()
    model = tfm.LM(cfg, device="meta")
    assert model.kinds == ["mla_dense"] + ["mla_moe"] * 3
    assert all(isinstance(lp.attn, attn.MLA) for lp in model.layers)
    ffn = model.layers[1].ffn
    assert isinstance(ffn, moe.MoE) and not isinstance(model.layers[0].ffn,
                                                       moe.MoE)
    assert ffn.shared.w_up.shape == (cfg.d_model, cfg.moe_d_ff
                                     * cfg.n_shared_experts)
    assert (model.mtp_proj is not None) == cfg.mtp == (arch ==
                                                       "deepseek-v3-671b")
    if cfg.mtp:
        assert model.mtp_proj.shape == (2 * cfg.d_model, cfg.d_model)
    cache = tfm.init_cache(cfg, 2, 8, "cpu")
    assert len(cache) == 4
    assert {k: tuple(v.shape) for k, v in cache[3].items()} == \
        {"c_kv": (2, 8, cfg.kv_lora_rank), "k_rope": (2, 8, cfg.rope_head_dim)}


# -- the reference's tests/test_mla.py, on the port alone -------------------

def _mla_only(name):
    """All layers dense-FFN MLA, no MTP (the reference test's config)."""
    cfg = configs.get_config(name).reduced()
    return dataclasses.replace(cfg, moe=False, n_experts=0,
                               experts_per_tok=0, n_shared_experts=0,
                               dense_layers=cfg.n_layers, mtp=False)


def _decode(cfg, params, toks, absorbed):
    cache = tfm.init_cache(cfg, toks.shape[0], 8, "cpu")
    step = steps.make_decode_step(cfg, mla_absorbed=absorbed)
    out = []
    for pos in range(toks.shape[1]):
        lg, cache = step(params, cache, {"tokens": toks[:, pos:pos + 1],
                                         "pos": pos})
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def test_mla_absorbed_matches_naive():
    cfg = _mla_only("deepseek-v2-236b")
    params = tfm.init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    naive = _decode(cfg, params, toks, False)
    absorbed = _decode(cfg, params, toks, True)
    err = float((absorbed - naive).abs().max())
    scale = float(naive.abs().max())
    assert err < 0.05 * max(scale, 1.0), (err, scale)


def test_mla_decode_matches_prefill():
    cfg = _mla_only("deepseek-v3-671b")
    params = tfm.init_params(cfg, 1, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 6),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = tfm.forward(params, {"tokens": toks}, cfg).float()
    dec = _decode(cfg, params, toks, True)
    err = float((dec - full).abs().max())
    assert err < 0.2, err
