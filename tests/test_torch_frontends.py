"""The audio and vision frontends against the JAX package: hubert-xlarge
(``front_proj`` of precomputed frame embeddings, a non-causal LayerNorm /
GELU encoder, no RoPE) and pixtral-12b (precomputed patch embeddings in
the first ``n_patches`` slots, then the text, positions 0 .. S-1 over the
whole sequence), on their reduced configs with the reference's weights
carried across unchanged.

Tolerances: the embedded inputs within one bf16 rounding (2^-7 of the
scale); whole-model logits within 3% of their scale, as in
``test_torch_lm.py`` (bf16 ulps of the two frameworks differ here and
there and the layers carry them on); losses within 2e-3 (float32 CE over
those logits).  The flash route (the plain B8 on CPU tensors) must give
pixtral's ``_sdpa`` result and leave hubert's non-causal attention on
``_sdpa``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as jsteps
from repro.nn import transformer as jtfm
from repro_torch import configs
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.nn import transformer as tfm
from repro_torch.weights import lm_params_from_numpy

torch.set_num_threads(1)

HUBERT, PIXTRAL = "hubert-xlarge", "pixtral-12b"
LOGIT_TOL = 0.03
LOSS_TOL = 2e-3
S = 40


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=[HUBERT, PIXTRAL])
def model(request):
    """(port config, reference config, reference params, the port's
    converted copy) of one reduced frontend arch."""
    arch = request.param
    cfg, rcfg = configs.get_config(arch).reduced(), \
        ref_config(arch).reduced()
    jp = jtfm.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               cfg)


def _batch(cfg, seed=0):
    """numpy inputs and labels of one batch of 2 x S positions: frames
    (audio), or n_patches patch embeddings then S - n_patches tokens."""
    rng = np.random.default_rng(seed)
    st = S - cfg.n_patches
    b = {"labels": rng.integers(0, cfg.vocab, (2, st)).astype(np.int32)}
    if cfg.frontend == "audio":
        b["frames"] = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (2, st)).astype(np.int32)
        b["patch_embeds"] = rng.normal(0, 1, (2, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return b


def _both(b):
    """(the port's batch, the reference's): bf16 embeddings, int tokens."""
    ours = {k: (torch.tensor(v).bfloat16() if v.dtype == np.float32
                else torch.tensor(v, dtype=torch.long)) for k, v in b.items()}
    theirs = {k: (jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
                  else jnp.asarray(v)) for k, v in b.items()}
    return ours, theirs


def test_embed_inputs_match_reference(model):
    cfg, rcfg, jp, p = model
    ours, theirs = _both(_batch(cfg))
    got = tfm._embed_inputs(p, ours, cfg)
    want = jtfm._embed_inputs(jp, theirs, rcfg)
    assert got.shape == (2, S, cfg.d_model) and got.dtype == torch.bfloat16
    assert _rel(got.float(), want.astype(jnp.float32)) <= 2.0 ** -7
    if cfg.frontend == "vision":     # the patches pass through unchanged
        assert torch.equal(got[:, :cfg.n_patches], ours["patch_embeds"])


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_step_matches_reference(model, flash):
    """Last-position logits of the prefill step against the reference's
    ``_sdpa`` route, on either route of the port; the flash route runs the
    plain B8 here (no launch) and only on pixtral's causal layers."""
    cfg, rcfg, jp, p = model
    ours, theirs = _both(_batch(cfg))
    want = jsteps.make_prefill_step(rcfg)(jp, theirs).astype(jnp.float32)
    calls = []
    hook = (lambda q, k, v: calls.append(1) or
            ops.flash_attention_op(q, k, v)) if flash else None
    before = dict(kbuild.LAUNCHES)
    got = steps.make_prefill_step(cfg, hook)(p, ours)
    assert kbuild.LAUNCHES == before
    assert len(calls) == (cfg.n_layers if flash and not cfg.encoder_only
                          else 0)
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= LOGIT_TOL


def test_loss_matches_reference(model):
    """hubert: CE over every frame; pixtral: over the text positions
    only."""
    cfg, rcfg, jp, p = model
    ours, theirs = _both(_batch(cfg, 1))
    want = float(jtfm.loss_fn(jp, theirs, rcfg))
    with torch.no_grad():
        got = float(tfm.loss_fn(p, ours, cfg))
    assert np.isfinite(got) and abs(got - want) <= LOSS_TOL, (got, want)


def test_attention_reaches_as_the_mask_says(model):
    """hubert attends both ways (a change in the last frame moves the
    first position's logits); pixtral is causal (it moves no earlier
    position) and its text reads the patches."""
    cfg, _, _, p = model
    b = _batch(cfg, 2)
    ours, _ = _both(b)
    key = "frames" if cfg.frontend == "audio" else "tokens"
    b2 = {k: v.copy() for k, v in b.items()}
    b2[key][:, -1] = b2[key][:, -1] * 0 + (1 if key == "tokens" else 0.5)
    with torch.no_grad():
        one = tfm.forward(p, ours, cfg).float()
        two = tfm.forward(p, _both(b2)[0], cfg).float()
    moved = (one[:, :-1] != two[:, :-1]).any(-1).any(0)
    if cfg.encoder_only:
        assert moved[0]
    else:
        assert not moved.any()
        b3 = {k: v.copy() for k, v in b.items()}
        b3["patch_embeds"][:, 0] += 1.0
        with torch.no_grad():
            three = tfm.forward(p, _both(b3)[0], cfg).float()
        assert (three[:, cfg.n_patches:] != one[:, cfg.n_patches:]).any()


def test_pixtral_decode_steps_match_reference():
    """Four text-token decode steps (the reference's decode feeds no
    patches): logits and both halves of every layer's cache."""
    cfg, rcfg = configs.get_config(PIXTRAL).reduced(), \
        ref_config(PIXTRAL).reduced()
    jp = jtfm.init_params(jax.random.PRNGKey(1), rcfg)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 4)) \
        .astype(np.int32)
    jc, c = jtfm.init_cache(rcfg, 2, 8), tfm.init_cache(cfg, 2, 8, "cpu")
    jstep = jax.jit(jsteps.make_decode_step(rcfg))
    step = steps.make_decode_step(cfg)
    for pos in range(4):
        tk = toks[:, pos:pos + 1]
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(tk),
                                  "pos": jnp.int32(pos)})
        got, c = step(p, c, {"tokens": torch.tensor(tk, dtype=torch.long),
                             "pos": pos})
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        assert _rel(got, want) <= LOGIT_TOL
    for i, lc in enumerate(c):
        for k in ("k", "v"):
            assert _rel(lc[k].float(), jc["group0"][k][i]
                        .astype(jnp.float32)) <= LOGIT_TOL


def test_hubert_has_no_decode_step():
    cfg = configs.get_config(HUBERT)
    assert cfg.encoder_only and not cfg.supports_decode
    assert cfg.shape_supported("decode_32k")[0] is False
