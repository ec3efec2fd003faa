"""Port kernel B8 and GQA attention: the plain flash version against the
reference's oracle ``kernels/ref.py::flash_attention_ref``, and the port's
``_sdpa`` / ``gqa_prefill`` / ``gqa_decode`` against the reference's.  The
CUDA cases (kernel == plain version) are in test_torch_cuda.py.

Tolerances: float32 attention at the reference's own 2e-5 (its kernel
test); bfloat16 attention outputs within one bf16 rounding of the
reference's (2^-7 of each value: the float32 math agrees to ~1e-6, and two
roundings to bf16 of nearly equal values differ by at most one ulp); a
projection of such values (``wo``) within one bf16 ulp of its largest
value (2^-7 of the scale), since one-ulp differences of its inputs add up
over the contraction."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro_torch.configs import get_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (check_aligned,
                                                 flash_attention_ref,
                                                 pad_heads)
from repro_torch.nn import attention as attn

torch.set_num_threads(1)

# the reference's test_kernels.py shapes (S, H, Hkv, hd), then ragged S,
# then the widths of phi3-mini-3.8b (96) and minitron / deepseek-67b /
# jamba (128)
SHAPES = [(256, 4, 4, 64), (256, 8, 2, 64), (128, 4, 1, 32), (100, 4, 2, 32),
          (33, 2, 1, 16), (100, 4, 2, 96), (70, 4, 4, 96), (64, 4, 1, 128),
          (100, 8, 2, 128)]


def _qkv(s, h, hkv, hd, seed, b=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (b, s, n, hd)).astype(np.float32)
                 for n in (h, hkv, hkv))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.as_tensor(a).to(dtype) for a in arrays)


def _j(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _within_bf16(got: torch.Tensor, want) -> bool:
    want = _f32(want)
    return bool(((got.float() - want).abs()
                 <= 2.0 ** -7 * want.abs() + 1e-6).all())


def _close(got: torch.Tensor, want) -> bool:
    want = _f32(want)
    return float((got.float() - want).abs().max()) \
        <= 2.0 ** -7 * float(want.abs().max())


@pytest.mark.parametrize("s,h,hkv,hd", SHAPES)
def test_plain_flash_matches_reference_oracle(s, h, hkv, hd):
    q, k, v = _qkv(s, h, hkv, hd, s + h)
    want = np.asarray(jref.flash_attention_ref(*_j(q, k, v)))
    got = flash_attention_ref(*_t(q, k, v))
    assert got.shape == (2, s, h, hd) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 2e-5


def test_plain_flash_bf16_matches_reference_oracle():
    q, k, v = _qkv(64, 4, 2, 32, 3)
    want = jref.flash_attention_ref(*_j(q, k, v, dtype=jnp.bfloat16))
    got = flash_attention_ref(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _within_bf16(got, want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_head_route_matches_reference_oracle_at_hd80(dtype):
    """The route B8 takes on the card at hd 80 (hubert's): q, k, v zero-
    padded to 96, the true 1/sqrt(80) scale, the padding sliced off; run
    through the plain version here, it equals the plain version and the
    reference's oracle at hd 80 (float32 at the oracle's 2e-5, bf16
    within one rounding)."""
    q, k, v = _qkv(100, 4, 2, 80, 11)
    tq, tk, tv = _t(q, k, v, dtype=dtype)
    qp, kp, vp, scale = pad_heads(tq, tk, tv)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == 96
    assert scale == 1 / math.sqrt(80)
    got = flash_attention_ref(qp, kp, vp, scale=scale)[..., :80]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jref.flash_attention_ref(*_j(q, k, v, dtype=jdt))
    if dtype == torch.float32:
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5
        assert float((got - flash_attention_ref(tq, tk, tv)).abs().max()) \
            < 2e-6
    else:
        assert _within_bf16(got, want.astype(jnp.float32))
    wide = torch.zeros((1, 4, 2, 136))
    with pytest.raises(ValueError, match="widest instantiation"):
        pad_heads(wide, wide, wide)


def test_flash_op_on_cpu_runs_the_plain_version():
    """CPU tensors take the plain version and count no kernel launch."""
    q, k, v = _t(*_qkv(40, 4, 2, 16, 5))
    before = dict(kbuild.LAUNCHES)
    assert torch.equal(ops.flash_attention_op(q, k, v),
                       flash_attention_ref(q, k, v))
    assert kbuild.LAUNCHES == before


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_reference(causal):
    q, k, v = _qkv(48, 4, 2, 32, 7)
    want = jattn._sdpa(*_j(q, k, v), causal=causal)
    got = attn._sdpa(*_t(q, k, v), causal=causal)
    assert got.shape == (2, 48, 128) and got.dtype == torch.bfloat16
    assert _within_bf16(got, want.astype(jnp.float32))


def test_sdpa_decode_mask_matches_reference():
    """Decode: one query against a cache with unwritten slots."""
    q, _, _ = _qkv(1, 4, 2, 32, 8)
    _, k, v = _qkv(16, 4, 2, 32, 9)
    want = jattn._sdpa(*_j(q, k, v), causal=False, kv_len=6)
    got = attn._sdpa(*_t(q, k, v), causal=False, kv_len=6)
    assert _within_bf16(got, want.astype(jnp.float32))


def _gqa_params(cfg, seed):
    d, hd = cfg.d_model, cfg.head_dim
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    p = {k: rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(s[0])
         for k, s in shapes.items()}
    mod = attn.GQA(d, cfg.n_heads, cfg.n_kv_heads, hd, device="meta")
    mod.load_state_dict({k: torch.as_tensor(a) for k, a in p.items()},
                        assign=True)
    return {k: jnp.asarray(a) for k, a in p.items()}, mod


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (2, s, cfg.d_model)).astype(np.float32)


def test_gqa_prefill_matches_reference():
    cfg, rcfg = get_config("tinyllama-1.1b").reduced(), \
        ref_config("tinyllama-1.1b").reduced()
    jp, p = _gqa_params(cfg, 1)
    x = _x(cfg, 40, 2)
    want, (wk, wv) = jattn.gqa_prefill(jp, jnp.asarray(x), rcfg)
    got, (k, v) = attn.gqa_prefill(p, torch.as_tensor(x), cfg)
    assert _close(got, want.astype(jnp.float32))
    for a, b in ((k, wk), (v, wv)):
        assert _within_bf16(a, b.astype(jnp.float32))


def test_flash_route_matches_reference_sdpa_route():
    """The port's flash route (flattened to (B, S, H*hd) before wo) against
    the reference's _sdpa route, which computes the same function; the
    reference's own flash route leaves the heads unflattened and raises
    (ROADMAP.md §C), so it is not the truth here."""
    cfg, rcfg = get_config("tinyllama-1.1b").reduced(), \
        ref_config("tinyllama-1.1b").reduced()
    jp, p = _gqa_params(cfg, 3)
    x = _x(cfg, 70, 4)
    want, _ = jattn.gqa_prefill(jp, jnp.asarray(x), rcfg)
    got, _ = attn.gqa_prefill(p, torch.as_tensor(x), cfg,
                              flash_impl=ops.flash_attention_op)
    assert got.shape == (2, 70, cfg.d_model)
    assert _close(got, want.astype(jnp.float32))
    with pytest.raises(TypeError):
        jattn.gqa_prefill(jp, jnp.asarray(x), rcfg,
                          flash_impl=jref.flash_attention_ref)


def test_gqa_decode_matches_reference():
    """Four decode steps: outputs and the cache written in place."""
    cfg, rcfg = get_config("tinyllama-1.1b").reduced(), \
        ref_config("tinyllama-1.1b").reduced()
    jp, p = _gqa_params(cfg, 5)
    shape = (2, 8, cfg.n_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape, jnp.bfloat16),
          "v": jnp.zeros(shape, jnp.bfloat16)}
    c = {"k": torch.zeros(shape, dtype=torch.bfloat16),
         "v": torch.zeros(shape, dtype=torch.bfloat16)}
    xs = _x(cfg, 4, 6)
    for pos in range(4):
        want, jc = jattn.gqa_decode(jp, jnp.asarray(xs[:, pos:pos + 1]), jc,
                                    pos, rcfg)
        got, c = attn.gqa_decode(p, torch.as_tensor(xs[:, pos:pos + 1]), c,
                                 pos, cfg)
        assert _close(got, want.astype(jnp.float32))
    for name in ("k", "v"):
        assert _within_bf16(c[name], jc[name].astype(jnp.float32))


def _kernel_arithmetic(q, k, v, split_p: bool, tile: int = 64):
    """The bf16 CUDA kernel's arithmetic in float32 torch: 64-key tiles, an
    online softmax on float32 scores (exact bf16 products, the 1/sqrt(hd)
    scale applied to the scores), P·V with P as bf16(p) + bf16(p - bf16(p))
    (``split_p``) or rounded once to bf16, the output rounded to bf16."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, hd))
    rows = torch.arange(s)
    for k0 in range(0, s, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        sc = (qf @ kt.transpose(-1, -2)) / math.sqrt(hd)
        keys = torch.arange(k0, k0 + kt.shape[2])
        sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)     # 0 on the first tile
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("split_p,holds", [(True, True), (False, False)])
def test_p_split_keeps_the_bf16_gate(split_p, holds):
    """Why the kernel multiplies P·V twice: with P split into two bf16
    terms its arithmetic meets the bf16 gate that chip_smoke.py and
    test_torch_cuda.py hold it to (every element within 2^-7 of |want| +
    1e-5 of the plain version rounded once to bf16); with P rounded once to
    bf16, as FlashAttention-2 does, outputs near zero fall outside it."""
    q, k, v = _t(*_qkv(1024, 4, 1, 64, 11, b=1), dtype=torch.bfloat16)
    want = flash_attention_ref(q, k, v).float()
    got = _kernel_arithmetic(q, k, v, split_p).float()
    inside = (got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5
    assert bool(inside.all()) == holds
    if not holds:
        assert int((~inside).sum()) > 1000


def test_bf16_alignment_check():
    """The bf16 kernel's 16-byte cp.async needs aligned bases and strides
    that are multiples of 8 elements; the wrapper raises on anything else
    (a dim of size 1 is never stepped, so its stride is free)."""
    buf = torch.zeros((2, 40, 3 * 64 + 8), dtype=torch.bfloat16)
    check_aligned(buf[..., :64].reshape(2, 40, 1, 64), "q")
    check_aligned(torch.zeros((1, 40, 1, 64), dtype=torch.bfloat16)
                  .as_strided((1, 40, 1, 64), (3, 64, 5, 1)), "q")
    with pytest.raises(ValueError, match="multiples of 8"):
        check_aligned(torch.zeros((2, 40, 2 * 64 + 4), dtype=torch.bfloat16)
                      [..., :64].reshape(2, 40, 1, 64), "q")
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned(buf[..., 1:65].reshape(2, 40, 1, 64), "k")
