"""The zoo against the JAX package: minitron-4b, phi3-mini-3.8b,
deepseek-67b and jamba-v0.1-52b (the jamba interleave with its MoE FFNs),
and deepseek-v2-236b and deepseek-v3-671b (MLA, the dense -> MoE prefix,
v3's MTP head), hubert-xlarge and pixtral-12b (the frontends), on their
reduced configs.  ``test_torch_lm.py`` holds the dense three (configs,
converter, prefill on both routes, decode, serving),
``test_torch_mla.py`` the MLA layer and ``test_torch_frontends.py`` the
frontends' steps; this file adds ``param_count`` / ``active_param_count``,
the converter of the nested and multi-group layouts, jamba's and
deepseek's routing, prefill, decode and (deepseek) loss, the flash route
at head widths 96 and 128, serving an ``ArchConfig`` and one train step
of each.

Tolerances.  Whole-model logits within 3% of their scale, as in
``test_torch_lm.py`` (bf16 roundings of the two frameworks differ by an
ulp here and there, and the layers carry it on).  Top-k routing is
discontinuous: those ulps move jamba's router probabilities by up to
~2e-3 (measured on the reduced jamba), more than the gap between two
experts' probabilities of some tokens, so the two models' hidden states
do not route alike everywhere (the reference's own ``tests/test_mla.py``
turns MoE off for that reason).  So the routing is held where both sides
see the same input: at every MoE layer of the reference's prefill and
decode steps, the port's ``moe_ffn`` on that layer's input routes exactly
as the reference (expert ids, positions in the expert, keep), with the
least router margin asserted above the float32 noise of a router logit,
and its output is within one bf16 rounding (2^-7 of the scale); and the
whole model is held to 3% with the port taking the reference's expert
choices (its own positions, drops, gates and expert products), the
number of choices its own router would make otherwise printed.  The
deepseek models are held the same way (their MoE layers follow the
dense prefix; their loss within 2e-3, v3's with the MTP term)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as jsteps
from repro.nn import moe as jmoe
from repro.nn import transformer as jtfm
from repro_torch import configs
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.nn import moe
from repro_torch.nn import transformer as tfm
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy

torch.set_num_threads(1)

ZOO = ["minitron-4b", "phi3-mini-3.8b", "deepseek-67b", "jamba-v0.1-52b",
       "deepseek-v2-236b", "deepseek-v3-671b", "hubert-xlarge",
       "pixtral-12b"]
JAMBA = "jamba-v0.1-52b"
DEEPSEEK = ["deepseek-v2-236b", "deepseek-v3-671b"]
LOGIT_TOL = 0.03
LOSS_TOL = 2e-3
ROUTER_NOISE = 1e-5     # far above a float32 router logit's rounding noise


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_model(arch, **replace):
    """(port config, reference config, reference params, the port's
    converted copy) of one reduced arch, fields replaced on both."""
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **replace)
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **replace)
    jp = jtfm.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               cfg)


# -- configs -----------------------------------------------------------------

def test_active_param_count():
    """The reference's jamba count is its full count (its MoE condition
    never holds at period 8, moe_every 2; ROADMAP.md §C); the port counts
    the 16 MoE layers of its layer plan, 14 of 16 experts idle in each.
    Elsewhere the two agree, and the port's count takes out of the
    analytic total what the idle experts of its modules hold."""
    ref, ours = ref_config(JAMBA), configs.get_config(JAMBA)
    assert ref.param_count() == ours.param_count() == 51_459_264_000
    assert ref.active_param_count() == 51_459_264_000
    per_expert = 4096 * 14336 * 3
    assert ours.active_param_count() == 11_999_251_968 == \
        51_459_264_000 - 16 * 14 * per_expert
    for arch in configs.ARCH_IDS:
        if arch != JAMBA:
            port, theirs = configs.get_config(arch), ref_config(arch)
            for a, b in ((port, theirs), (port.reduced(), theirs.reduced())):
                assert a.param_count() == b.param_count()
                assert a.active_param_count() == b.active_param_count()
    cfg = ours.reduced()
    model = tfm.LM(cfg, device="meta")
    moes = [m for m in model.modules() if isinstance(m, moe.MoE)]
    assert len(moes) == cfg.n_layers // cfg.moe_every
    idle = sum(m.w_up[0].numel() + m.w_gate[0].numel() + m.w_down[0].numel()
               for m in moes) * (cfg.n_experts - cfg.experts_per_tok)
    assert cfg.active_param_count() == cfg.param_count() - idle


# -- parameters --------------------------------------------------------------

@pytest.mark.parametrize("arch", [JAMBA, "minitron-4b", *DEEPSEEK,
                                  "hubert-xlarge", "pixtral-12b"])
def test_converter_round_trip(arch):
    """Every reference leaf (jamba's nested ``group0.sub{i}`` leaves,
    deepseek's two groups, stacked (E, ...) experts, the top-level
    ``front_proj``, ``mtp_norm`` and ``mtp_proj``) lands unchanged in one
    port parameter, and ``lm_params_to_numpy`` gives the reference's tree
    back."""
    cfg, _, jp, p = _ref_model(arch)
    first = np.cumsum([0] + [g.count for g in tfm.layer_groups(cfg)])
    sd, seen = p.state_dict(), 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        if keys[0].startswith("group"):
            for i in range(leaf.shape[0]):
                layer = first[int(keys[0][len("group"):])] + i
                name = ".".join(["layers", str(layer)] + keys[1:])
                assert np.array_equal(sd[name].numpy(), _f32(leaf[i])), name
                seen += 1
        else:
            assert np.array_equal(sd[".".join(keys)].numpy(), _f32(leaf))
            seen += 1
    assert seen == len(sd)
    back = lm_params_to_numpy(p, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32 and np.array_equal(a, _f32(b))


def test_jamba_layer_plan():
    """Sub-layer i of a period mixes with attention iff i == period // 2
    and its FFN is MoE iff i % moe_every == 1; caches follow."""
    for cfg in (configs.get_config(JAMBA), configs.get_config(JAMBA)
                .reduced()):
        per = cfg.attn_period
        period = tfm.JambaPeriod(cfg, device="meta")
        subs = list(period.children())
        assert [s.is_attn for s in subs] == [i == per // 2
                                              for i in range(per)]
        assert [isinstance(s.ffn, moe.MoE) for s in subs] == \
            [i % cfg.moe_every == 1 for i in range(per)]
        assert tfm.layer_groups(cfg) == [tfm.Group("jamba_period",
                                                   cfg.n_layers // per)]
    cache = tfm.init_cache(cfg, 2, 8, "cpu")
    assert len(cache) == 1 and set(cache[0]["sub2"]) == {"k", "v"}
    assert set(cache[0]["sub1"]) == {"state", "conv"}
    with pytest.raises(AssertionError):
        tfm.layer_groups(dataclasses.replace(cfg, n_layers=6))


# -- jamba: routing and the steps -------------------------------------------

def _tokens(vocab, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (2, s)) \
        .astype(np.int32)


@pytest.fixture
def ref_moe_log(monkeypatch):
    """Records every reference MoE call, in call order: (input x (B, S, d)
    float32, expert id, slot, keep) of its sort-mode ``_local_dispatch``
    (the routing ``_moe_ffn_dense`` computes)."""
    log = []
    real = jmoe._moe_ffn_dense

    def recorded(p, x, *, top_k, act, gated, capacity_factor=1.25):
        b, s, d = x.shape
        cap = max(1, int(capacity_factor * b * s * top_k
                         / p["router"].shape[-1]))
        _, fe, ic, kp, _ = jmoe._local_dispatch(x.reshape(b * s, d),
                                                p["router"], top_k, cap)
        jax.debug.callback(
            lambda *a: log.append(tuple(np.asarray(v) for v in a)),
            x.astype(jnp.float32), fe, ic, kp, ordered=True)
        return real(p, x, top_k=top_k, act=act, gated=gated,
                    capacity_factor=capacity_factor)

    monkeypatch.setattr(jmoe, "_moe_ffn_dense", recorded)
    return log


@pytest.fixture
def ref_choices():
    """The port's MoE calls take their expert choices from a queue of the
    reference's (expert ids of one MoE call, in call order); yields (the
    queue, the count a call of the tokens whose own top-k differs)."""
    queue = []
    with moe.replay_routing(queue) as changed:
        yield queue, changed


def _reference_run(rcfg, jp, toks, n_decode, log):
    """The reference's prefill logits and ``n_decode`` decode steps' logits
    (2 x 8 caches), each with its MoE calls (from ``ref_moe_log``)."""
    runs = []
    log.clear()
    want = jsteps.make_prefill_step(rcfg)(jp, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    runs.append((_f32(want), list(log)))
    jc = jtfm.init_cache(rcfg, 2, 8)
    jstep = jax.jit(jsteps.make_decode_step(rcfg))
    for pos in range(n_decode):
        log.clear()
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
                                  "pos": jnp.int32(pos)})
        jax.effects_barrier()
        runs.append((_f32(want), list(log)))
    return runs


def _moe_layers(p):
    return [m for m in p.modules() if isinstance(m, moe.MoE)]


def test_jamba_moe_layers_route_as_reference(ref_moe_log):
    """At every MoE layer of the reduced jamba's prefill (2 x 16) and three
    decode steps (capacity 1 a step), the port's ``moe_ffn`` on the
    reference's input routes exactly as the reference and its output is
    within one bf16 rounding of the reference's ``moe_ffn``."""
    cfg, rcfg, jp, p = _ref_model(JAMBA)
    runs = _reference_run(rcfg, jp, _tokens(cfg.vocab, 16, 0), 3,
                                ref_moe_log)
    layers = _moe_layers(p)
    jlayers = [jp["group0"][f"sub{i}"]["ffn"] for i in range(cfg.attn_period)
               if i % cfg.moe_every == 1]
    calls, dropped, margin = 0, 0, 1.0
    for _, moe_calls in runs:
        assert len(moe_calls) == len(layers)
        for layer, jlayer, (x, w_e, w_c, w_keep) in zip(layers, jlayers,
                                                        moe_calls):
            jl = jax.tree.map(lambda a: a[0], jlayer)
            xb = torch.tensor(x).bfloat16()
            with moe.record_routing() as routes:
                got = moe.moe_ffn(layer, xb, top_k=cfg.experts_per_tok,
                                  act=cfg.act, gated=cfg.gated_mlp)
            (flat_e, pos, keep, probs), = routes
            assert np.array_equal(flat_e.numpy(), w_e)
            assert np.array_equal(keep.numpy(), w_keep)
            assert np.array_equal(pos.numpy()[w_keep], w_c[w_keep])
            top = probs.double().topk(cfg.experts_per_tok + 1).values
            margin = min(margin, float((top[:, :-1] - top[:, 1:]).min()))
            want = jmoe.moe_ffn(jl, jnp.asarray(x, jnp.bfloat16),
                                top_k=cfg.experts_per_tok, act=cfg.act,
                                gated=cfg.gated_mlp)
            assert _rel(got.float(), want.astype(jnp.float32)) <= 2.0 ** -7
            calls += 1
            dropped += int((~keep).sum())
    print(f"{calls} MoE calls, {dropped} choices dropped, least router "
          f"margin {margin:.3g}")
    assert calls == 4 * len(layers) and dropped > 0
    assert margin > ROUTER_NOISE


@pytest.mark.parametrize("flash", [False, True])
def test_jamba_steps_match_reference(ref_moe_log, ref_choices, flash,
                                     capsys):
    """The reduced jamba's prefill step (``_sdpa`` or flash route) and
    three decode steps against the reference's, within 3%, with the port
    taking the reference's expert choices (``_gates`` reads them in call
    order); the choices the port's router would change are counted."""
    cfg, rcfg, jp, p = _ref_model(JAMBA)
    toks = _tokens(cfg.vocab, 16, 0)
    runs = _reference_run(rcfg, jp, toks, 3, ref_moe_log)
    queue, changed = ref_choices
    (want, moe_calls), *decodes = runs
    queue += [c[1] for c in moe_calls]
    before = dict(kbuild.LAUNCHES)
    got = steps.make_prefill_step(
        cfg, ops.flash_attention_op if flash else None)(
            p, {"tokens": torch.as_tensor(toks, dtype=torch.long)})
    assert kbuild.LAUNCHES == before          # CPU: the plain B8
    assert got.shape == (2, cfg.vocab) and not queue
    assert _rel(got.float(), want) <= LOGIT_TOL
    c = tfm.init_cache(cfg, 2, 8, "cpu")
    step = steps.make_decode_step(cfg)
    for pos, (want, moe_calls) in enumerate(decodes):
        queue += [c_[1] for c_ in moe_calls]
        got, c = step(p, c, {"tokens": torch.as_tensor(
            toks[:, pos:pos + 1], dtype=torch.long), "pos": pos})
        assert got.shape == (2, 1, cfg.vocab) and not queue
        assert _rel(got, want) <= LOGIT_TOL
    with capsys.disabled():
        print(f"\n[jamba, flash={flash}] tokens whose own top-2 differs "
              f"from the reference's, by MoE call: {changed}")


# -- deepseek v2/v3: the MoE layers after the dense prefix ------------------

def _route_check(layer, x, w_e, w_c, w_keep, jl, cfg):
    """The port's ``moe_ffn`` on the reference's layer input: routing
    exact, output within one bf16 rounding; returns (the least router
    margin, dropped choices)."""
    with moe.record_routing() as routes:
        got = moe.moe_ffn(layer, torch.tensor(x).bfloat16(),
                          top_k=cfg.experts_per_tok, act=cfg.act,
                          gated=cfg.gated_mlp)
    (flat_e, pos, keep, probs), = routes
    assert np.array_equal(flat_e.numpy(), w_e)
    assert np.array_equal(keep.numpy(), w_keep)
    assert np.array_equal(pos.numpy()[w_keep], w_c[w_keep])
    want = jmoe.moe_ffn(jl, jnp.asarray(x, jnp.bfloat16),
                        top_k=cfg.experts_per_tok, act=cfg.act,
                        gated=cfg.gated_mlp)
    assert _rel(got.float(), want.astype(jnp.float32)) <= 2.0 ** -7
    top = probs.double().topk(cfg.experts_per_tok + 1).values
    return float((top[:, :-1] - top[:, 1:]).min()), int((~keep).sum())


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_moe_layers_route_as_reference(arch, ref_moe_log):
    """At each of the reduced model's three MoE layers (after its one
    dense MLA layer), in the prefill step (2 x 16) and four decode steps,
    the port routes the reference's layer input exactly as the
    reference; the shared expert is in both outputs."""
    cfg, rcfg, jp, p = _ref_model(arch)
    runs = _reference_run(rcfg, jp, _tokens(cfg.vocab, 16, 4), 4,
                          ref_moe_log)
    layers = _moe_layers(p)
    assert len(layers) == 3 and all(m.shared is not None for m in layers)
    calls, dropped, margin = 0, 0, 1.0
    for _, moe_calls in runs:
        assert len(moe_calls) == len(layers)
        for i, (layer, call) in enumerate(zip(layers, moe_calls)):
            jl = jax.tree.map(lambda a: a[i], jp["group1"]["ffn"])
            m, d = _route_check(layer, *call, jl, cfg)
            margin, dropped, calls = min(margin, m), dropped + d, calls + 1
    print(f"{calls} MoE calls, {dropped} choices dropped, least router "
          f"margin {margin:.3g}")
    assert calls == 5 * len(layers) and dropped > 0
    assert margin > ROUTER_NOISE


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_steps_match_reference(arch, ref_moe_log, ref_choices):
    """With the reference's expert choices: the prefill step on both
    routes (MLA never takes the flash hook: the same logits, no hook
    call), four absorbed decode steps within 3%, and ``loss_fn`` (v3:
    with the MTP term) within 2e-3 at 2 x 64 tokens."""
    cfg, rcfg, jp, p = _ref_model(arch)
    toks = _tokens(cfg.vocab, 16, 5)
    runs = _reference_run(rcfg, jp, toks, 4, ref_moe_log)
    queue, _ = ref_choices
    (want, moe_calls), *decodes = runs
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long)}
    hooked = []
    got = {}
    for route, hook in (("sdpa", None),
                        ("flash", lambda *a: hooked.append(1))):
        queue += [c[1] for c in moe_calls]
        got[route] = steps.make_prefill_step(cfg, hook)(p, batch)
        assert not queue
    assert not hooked and torch.equal(got["sdpa"], got["flash"])
    assert _rel(got["sdpa"].float(), want) <= LOGIT_TOL
    c = tfm.init_cache(cfg, 2, 8, "cpu")
    step = steps.make_decode_step(cfg)
    for pos, (want, moe_calls) in enumerate(decodes):
        queue += [c_[1] for c_ in moe_calls]
        lg, c = step(p, c, {"tokens": torch.as_tensor(
            toks[:, pos:pos + 1], dtype=torch.long), "pos": pos})
        assert lg.shape == (2, 1, cfg.vocab) and not queue
        assert _rel(lg, want) <= LOGIT_TOL
    # the loss is a mean of per-position CEs, each off by bf16 noise of
    # either sign: over 2 x 16 positions the gap read 0.5-3.1e-3 across six
    # token seeds, over 2 x 64 0.15-1.55e-3; so 2 x 64, three seeds
    for seed in range(3):
        toks, labels = (_tokens(cfg.vocab, 64, 20 + 2 * seed + i)
                        for i in (0, 1))
        ref_moe_log.clear()
        want = float(jtfm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)}, rcfg))
        jax.effects_barrier()
        queue += [c_[1] for c_ in ref_moe_log]
        with torch.no_grad():
            got = float(tfm.loss_fn(p, {
                "tokens": torch.as_tensor(toks, dtype=torch.long),
                "labels": torch.as_tensor(labels, dtype=torch.long)}, cfg))
        assert not queue and abs(got - want) <= LOSS_TOL, (seed, got, want)


def test_mtp_term_is_in_the_loss():
    """v3's loss is its CE plus MTP_WEIGHT times the MTP head's CE against
    the labels one further on (the last position ignored): dropping the
    head's projection to zero leaves a uniform CE of ln(vocab) for it."""
    cfg = configs.get_config("deepseek-v3-671b").reduced()
    p = tfm.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(_tokens(cfg.vocab, 9, 7), dtype=torch.long)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        main = float(tfm._ce(tfm.forward(p, batch, cfg), batch["labels"]))
        p.mtp_proj.zero_()
        total = float(tfm.loss_fn(p, batch, cfg))
    assert abs(total - (main + tfm.MTP_WEIGHT * np.log(cfg.vocab))) < 1e-4


# -- the flash route at head widths 96 and 128 -------------------------------

@pytest.mark.parametrize("arch,hd", [("phi3-mini-3.8b", 96),
                                     ("minitron-4b", 128),
                                     ("deepseek-67b", 128)])
def test_flash_route_at_wide_heads(arch, hd):
    """The reduced config at its published head width: the flash route
    (the plain B8 on CPU tensors) equals the ``_sdpa`` route within one
    bf16 rounding of the logits' scale, and both are within 3% of the
    reference's ``_sdpa`` route."""
    cfg, rcfg, jp, p = _ref_model(arch, head_dim=hd)
    toks = _tokens(cfg.vocab, 40, 2)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long)}
    want = _f32(jsteps.make_prefill_step(rcfg)(
        jp, {"tokens": jnp.asarray(toks)}).astype(jnp.float32))
    before = dict(kbuild.LAUNCHES)
    sdpa = steps.make_prefill_step(cfg)(p, batch).float()
    flash = steps.make_prefill_step(cfg, ops.flash_attention_op)(p, batch) \
        .float()
    assert kbuild.LAUNCHES == before
    assert _rel(flash, sdpa) <= 2.0 ** -7
    assert _rel(sdpa, want) <= LOGIT_TOL and _rel(flash, want) <= LOGIT_TOL


# -- serving and training ------------------------------------------------------

def test_serve_jamba_and_an_arch_config():
    st = serve.serve(JAMBA, reduced=True, batch=2, prompt_len=5, gen=4,
                     max_seq=16, device="cpu")
    assert st["tokens"].shape == (2, 4) and st["arch"] == f"{JAMBA}-reduced"
    assert ((st["tokens"] >= 0) & (st["tokens"] < 512)).all()
    cut = dataclasses.replace(configs.get_config("phi3-mini-3.8b").reduced(),
                              name="phi3-cut", n_layers=2, head_dim=96)
    st = serve.serve(cut, batch=2, prompt_len=5, gen=3, max_seq=16,
                     device="cpu")
    assert st["arch"] == "phi3-cut" and st["tokens"].shape == (2, 3)
    again = serve.serve(cut, batch=2, prompt_len=5, gen=3, max_seq=16,
                        device="cpu")
    assert np.array_equal(again["tokens"], st["tokens"])


@pytest.mark.parametrize("arch", ZOO)
def test_train_step(arch):
    """One train step from the port's own init: a finite loss and moved
    parameters (as the reference's ``test_forward_and_train_step``)."""
    cfg = configs.get_config(arch).reduced()
    params = tfm.init_params(cfg, 0, "cpu")
    before = {k: v.clone() for k, v in params.named_parameters()}
    toks = torch.as_tensor(_tokens(cfg.vocab, 17, 3), dtype=torch.long)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    embeds = torch.randn((2, 16 + cfg.n_patches, cfg.d_model),
                         generator=torch.Generator().manual_seed(3))
    if cfg.frontend == "audio":
        batch = {"frames": embeds.bfloat16(), "labels": toks[:, 1:]}
    elif cfg.frontend == "vision":
        batch["patch_embeds"] = embeds[:, :cfg.n_patches].bfloat16()
    step = steps.make_train_step(cfg, OptConfig(warmup_steps=2))
    params, _, m = step(params, adamw_init(dict(params.named_parameters())),
                        batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moved = [k for k, v in params.named_parameters()
             if not torch.equal(v, before[k])]
    assert "embed" in moved and len(moved) > len(before) // 2
