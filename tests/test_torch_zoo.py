"""The zoo slice against the JAX package: minitron-4b, phi3-mini-3.8b,
deepseek-67b and jamba-v0.1-52b (the jamba interleave with its MoE FFNs),
on their reduced configs.  ``test_torch_lm.py`` holds the dense three
(configs, converter, prefill on both routes, decode, serving); this file
adds what is new with them: ``active_param_count``, jamba's converter,
routing, prefill and decode, the flash route at head widths 96 and 128,
serving an ``ArchConfig`` and one train step of each.

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
number of choices its own router would make otherwise printed."""
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

ZOO = ["minitron-4b", "phi3-mini-3.8b", "deepseek-67b", "jamba-v0.1-52b"]
JAMBA = "jamba-v0.1-52b"
LOGIT_TOL = 0.03
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
    for arch in configs.PORTED_ARCH_IDS:
        if arch != JAMBA:
            assert configs.get_config(arch).active_param_count() == \
                ref_config(arch).active_param_count()
    cfg = ours.reduced()
    model = tfm.LM(cfg, device="meta")
    moes = [m for m in model.modules() if isinstance(m, moe.MoE)]
    assert len(moes) == cfg.n_layers // cfg.moe_every
    idle = sum(m.w_up[0].numel() + m.w_gate[0].numel() + m.w_down[0].numel()
               for m in moes) * (cfg.n_experts - cfg.experts_per_tok)
    assert cfg.active_param_count() == cfg.param_count() - idle


# -- parameters --------------------------------------------------------------

@pytest.mark.parametrize("arch", [JAMBA, "minitron-4b"])
def test_converter_round_trip(arch):
    """Every reference leaf (jamba's nested ``group0.sub{i}`` leaves and
    stacked (E, ...) experts among them) lands unchanged in one port
    parameter, and ``lm_params_to_numpy`` gives the reference's tree
    back."""
    cfg, _, jp, p = _ref_model(arch)
    sd, seen = p.state_dict(), 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        if keys[0] == "group0":
            for i in range(leaf.shape[0]):
                name = ".".join(["layers", str(i)] + keys[1:])
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


def _jamba_reference_run(rcfg, jp, toks, n_decode, log):
    """The reference's prefill logits and ``n_decode`` decode steps' logits,
    each with its MoE calls (from ``ref_moe_log``)."""
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
    runs = _jamba_reference_run(rcfg, jp, _tokens(cfg.vocab, 16, 0), 3,
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
def test_jamba_steps_match_reference(ref_moe_log, monkeypatch, flash,
                                     capsys):
    """The reduced jamba's prefill step (``_sdpa`` or flash route) and
    three decode steps against the reference's, within 3%, with the port
    taking the reference's expert choices (``_gates`` reads them in call
    order); the choices the port's router would change are counted."""
    cfg, rcfg, jp, p = _ref_model(JAMBA)
    toks = _tokens(cfg.vocab, 16, 0)
    runs = _jamba_reference_run(rcfg, jp, toks, 3, ref_moe_log)
    queue, changed = [], []

    def ref_gates(xt, router, top_k):
        probs = torch.softmax(xt.float() @ router.float(), dim=-1)
        idx = torch.as_tensor(queue.pop(0)).reshape(-1, top_k)
        own = probs.topk(top_k, dim=-1).indices
        changed.append(int((own != idx).any(-1).sum()))
        vals = probs.gather(-1, idx)
        return probs, vals / (vals.sum(-1, keepdim=True) + 1e-9), idx

    monkeypatch.setattr(moe, "_gates", ref_gates)
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
    step = steps.make_train_step(cfg, OptConfig(warmup_steps=2))
    params, _, m = step(params, adamw_init(dict(params.named_parameters())),
                        batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moved = [k for k, v in params.named_parameters()
             if not torch.equal(v, before[k])]
    assert "embed" in moved and len(moved) > len(before) // 2
