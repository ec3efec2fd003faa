"""The port's plaintext LM path against the JAX package: configs, layers,
the weight converter, the prefill step (``_sdpa`` and flash routes), the
decode step and the serving launcher, on the reduced configs of the
reference's architectures: TinyLlama-1.1B, Minitron-4B, Phi-3-mini and
DeepSeek-67B (dense GQA), Mamba2-1.3B (SSM) and Jamba-v0.1 (the hybrid
Mamba / attention / MoE interleave; ``test_torch_zoo.py`` holds its
routing to the reference's); the configs, init and serving of
DeepSeek-V2/V3 (MLA, MoE), HuBERT and Pixtral too (their steps:
``test_torch_mla.py``, ``test_torch_frontends.py``,
``test_torch_zoo.py``).

Tolerances: float32 layer math (RoPE, the unrounded RMSNorm) at 1e-6 of
its scale; a bf16 value computed the same way on both sides (RMSNorm,
RoPE, embedding, the MLP's projections) within one bf16 rounding of each
value (2^-7 of it); whole-model logits, bf16 (prefill) or float32 from
bf16 hidden states (decode), within 3% of their scale: bf16 roundings in
the two frameworks differ by one ulp (2^-8) here and there (torch's SiLU
rounds once, XLA's bf16 logistic three times; their bf16 matmuls differ
by one ulp at large K), and four layers carry each difference on to the
logits (0.75% at the largest, TinyLlama's prefill, on this tree)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import steps as jsteps
from repro.nn import layers as jlayers
from repro.nn import transformer as jtfm
from repro_torch import configs
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.nn import layers
from repro_torch.nn import transformer as tfm
from repro_torch.weights import lm_params_from_numpy

torch.set_num_threads(1)

ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "minitron-4b", "phi3-mini-3.8b",
         "deepseek-67b", "jamba-v0.1-52b"]
ALL_ARCHS = ARCHS + ["deepseek-v2-236b", "deepseek-v3-671b", "hubert-xlarge",
                     "pixtral-12b"]
# the models whose whole-model steps route nothing: jamba's MoE routing
# needs the reference's expert choices to compare (test_torch_zoo.py)
STEP_ARCHS = [a for a in ARCHS if a != "jamba-v0.1-52b"]
# every model with a decode step (hubert is encoder-only)
SERVE_ARCHS = [a for a in ALL_ARCHS if a != "hubert-xlarge"]
LOGIT_TOL = 0.03


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _close(got: torch.Tensor, want, rel: float) -> bool:
    want = _f32(want)
    return float((got.float() - want).abs().max()) \
        <= rel * float(want.abs().max())


def _within_bf16(got: torch.Tensor, want) -> bool:
    want = _f32(want)
    return bool(((got.float() - want).abs()
                 <= 2.0 ** -7 * want.abs() + 1e-6).all())


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_reference(arch):
    ours, ref = configs.get_config(arch), ref_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert ours.param_count() == ref.param_count()
    assert ours.reduced().param_count() == ref.reduced().param_count()
    assert configs.SHAPES == REF_SHAPES


def test_every_arch_resolves():
    """Every one of the reference's architectures resolves in the port and
    builds its reduced ``LM`` (on the meta device); an unknown name
    raises."""
    assert sorted(configs.ARCH_IDS) == sorted(ALL_ARCHS)
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        assert cfg.name == arch
        model = tfm.LM(cfg.reduced(), device="meta")
        assert len(model.layers) == sum(g.count for g in
                                        tfm.layer_groups(cfg.reduced()))
    with pytest.raises(ValueError):
        configs.get_config("gpt-5")


# -- layers ------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 24, 128)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    xb, jxb = torch.as_tensor(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    # RMSNorm: float32 math, bf16 and float32 outputs
    assert _within_bf16(layers.rmsnorm(torch.as_tensor(g), xb),
                        jlayers.rmsnorm(jnp.asarray(g), jxb)
                        .astype(jnp.float32))
    assert _close(layers.rmsnorm(torch.as_tensor(g), torch.as_tensor(x)),
                  jlayers.rmsnorm(jnp.asarray(g), jnp.asarray(x)), 1e-6)
    # RoPE on (B, S, H, hd)
    q = rng.normal(0, 1, (2, 24, 4, 32)).astype(np.float32)
    pos = np.arange(24)
    assert _close(layers.apply_rope(torch.as_tensor(q), torch.as_tensor(pos)),
                  jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos)), 1e-6)
    assert _within_bf16(
        layers.apply_rope(torch.as_tensor(q).bfloat16(),
                          torch.as_tensor(pos)),
        jlayers.apply_rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos))
        .astype(jnp.float32))
    # embedding: a bf16 gather
    table = rng.normal(0, 0.02, (512, 128)).astype(np.float32)
    toks = rng.integers(0, 512, (2, 24))
    got = layers.embed(torch.as_tensor(table), torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), _f32(jlayers.embed(
        jnp.asarray(table), jnp.asarray(toks)).astype(jnp.float32)))
    # gated SiLU MLP
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 128, 256, True)
    p = layers.MLP(128, 256, True, device="meta")
    p.load_state_dict({k: _f32(v) for k, v in jp.items()}, assign=True)
    assert _close(layers.mlp(p, xb, "silu", True),
                  jlayers.mlp(jp, jxb, "silu", True).astype(jnp.float32),
                  2.0 ** -7)


# -- parameters --------------------------------------------------------------

@pytest.fixture(scope="module", params=STEP_ARCHS)
def models(request):
    """(port config, reference config, reference params, the port's
    converted copy) for one reduced arch."""
    arch = request.param
    cfg, rcfg = configs.get_config(arch).reduced(), \
        ref_config(arch).reduced()
    jp = jtfm.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg)


def test_converter_carries_every_leaf(models):
    """Every reference leaf lands, unchanged, in one port parameter; the
    stacked group leaves split one layer (or jamba period) per module,
    nested leaves keep their path."""
    cfg, _, jp, p = models
    sd, seen = p.state_dict(), 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        if keys[0] == "group0":
            for i in range(leaf.shape[0]):
                name = ".".join(["layers", str(i)] + keys[1:])
                assert torch.equal(sd[name], _f32(leaf[i])), name
                seen += 1
        else:
            assert torch.equal(sd[".".join(keys)], _f32(leaf))
            seen += 1
    assert seen == len(sd)
    assert not any(t.requires_grad for t in p.parameters())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_distributions(arch):
    """The port's own init: the reference's shapes and distributions."""
    cfg = configs.get_config(arch).reduced()
    p = tfm.init_params(cfg, 0, "cpu")
    assert sum(t.numel() for t in p.parameters()) == \
        sum(t.numel() for t in lm_params_from_numpy(
            jax.tree.map(np.asarray,
                         jtfm.init_params(jax.random.PRNGKey(0),
                                          ref_config(arch).reduced())),
            cfg).parameters())
    d = cfg.d_model
    assert abs(float(p.embed.std()) - 0.02) < 0.002
    w = {"dense": lambda: p.layers[0].attn.wq,
         "moe": lambda: p.layers[0].attn.w_dkv,
         "audio": lambda: p.front_proj,
         "vlm": lambda: p.layers[0].attn.wq,
         "ssm": lambda: p.layers[0].mamba.w_in,
         "hybrid": lambda: p.layers[0].sub0.mamba.w_in}[cfg.family]()
    assert float(w.abs().max()) <= 1 / np.sqrt(d)
    assert abs(float(w.std()) - 1 / np.sqrt(3 * d)) < 0.05 / np.sqrt(d)
    gain = p.final_norm if cfg.norm == "rmsnorm" else p.final_norm.g
    assert torch.equal(gain, torch.ones(d))
    assert not torch.equal(p.embed, tfm.init_params(cfg, 1, "cpu").embed)


# -- steps -------------------------------------------------------------------

def _tokens(cfg, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, s)) \
        .astype(np.int32)


def test_prefill_step_matches_reference(models):
    cfg, rcfg, jp, p = models
    toks = _tokens(cfg, 40)
    want = jsteps.make_prefill_step(rcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.as_tensor(toks, dtype=torch.long)})
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.bfloat16
    assert _close(got, want.astype(jnp.float32), LOGIT_TOL)
    if cfg.n_heads:
        # the flash route against the reference's _sdpa route (its own
        # flash route raises, ROADMAP.md §C); every attention layer on the
        # plain B8
        before = dict(kbuild.LAUNCHES)
        flash = steps.make_prefill_step(cfg, ops.flash_attention_op)(
            p, {"tokens": torch.as_tensor(toks, dtype=torch.long)})
        assert kbuild.LAUNCHES == before      # CPU: the plain version
        assert _close(flash, want.astype(jnp.float32), LOGIT_TOL)


def test_decode_steps_match_reference(models):
    """Five decode steps from an empty cache: logits and caches."""
    cfg, rcfg, jp, p = models
    toks = _tokens(cfg, 5, 1)
    jc, c = jtfm.init_cache(rcfg, 2, 8), tfm.init_cache(cfg, 2, 8, "cpu")
    jstep = jax.jit(jsteps.make_decode_step(rcfg))
    step = steps.make_decode_step(cfg)
    for pos in range(5):
        tk = toks[:, pos:pos + 1]
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(tk),
                                  "pos": jnp.int32(pos)})
        got, c = step(p, c, {"tokens": torch.as_tensor(tk, dtype=torch.long),
                             "pos": pos})
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        assert _close(got, want, LOGIT_TOL)
    assert len(c) == tfm.layer_groups(cfg)[0].count
    for i, lc in enumerate(c):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jc["group0"]):
            t = lc
            for key in path:
                t = t[key.key]
            assert _close(t, leaf[i].astype(jnp.float32), LOGIT_TOL)


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_on_cpu(arch, capsys):
    st = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                     "--prompt-len", "5", "--gen", "4", "--max-seq", "16",
                     "--device", "cpu", "--profile"])
    assert st["tokens"].shape == (2, 4) and st["kind"] == "cpu"
    assert ((st["tokens"] >= 0) & (st["tokens"] < 512)).all()
    assert st["prefill_tok_s"] > 0 and st["decode_tok_s"] > 0
    assert st["peak_mem_bytes"] is None
    # CPU tensors: the profiled decode step has no device time
    assert st["profile"]["wall_us"] > 0 and st["profile"]["device_us"] == 0
    printed = capsys.readouterr().out
    assert "tok/s" in printed and "profiled decode step" in printed
    # the same prompt and weights give the same tokens
    again = serve.serve(arch, True, 2, 5, 4, 16, device="cpu")
    assert np.array_equal(again["tokens"], st["tokens"])


def test_serve_refuses_what_does_not_fit(monkeypatch):
    with pytest.raises(ValueError, match="max_seq"):
        serve.serve("tinyllama-1.1b", True, 1, 10, 10, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        serve.serve("hubert-xlarge", True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced"])
