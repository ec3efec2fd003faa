"""Port kernel B9 and the Mamba-2 block: the plain ``ssd_scan`` against the
reference's ``kernels/ssd.py::ssd_scan`` (its Pallas kernel in interpret
mode) and against the float64 recurrence; a plain-torch model of the CUDA
kernel's four chunk-parallel passes against both; and ``ssd_prefill`` /
``ssd_decode`` against the reference's.  The CUDA cases (kernel == plain
version) are in test_torch_cuda.py.

Tolerances: the scan in float32 at the reference's 5e-4 (its kernel test
against the recurrence); the port's scan against the Pallas kernel at 1e-5
(both float32, same chunk math, other summation orders); the passes'
model at 1e-6 of the scale of y against the plain version and 1e-5
against the Pallas kernel (see its test); the block's bf16
output within one bf16 ulp of its largest value (2^-7 of the scale: the
output projection sums one-ulp differences of its bf16 input); the decode
step's bf16 conv cache (the input projection's output) within one bf16
rounding of each value; the float32 SSM state at 1e-5 of its scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ssd import ssd_scan as jssd_scan
from repro.nn import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ssd
from repro_torch.nn import ssm

torch.set_num_threads(1)

SHAPES = [(128, 2, 32, 16, 64), (256, 1, 64, 32, 64), (64, 4, 16, 8, 32)]


def _recurrence(x, bmat, cmat, da, dt):
    """The sequential SSM recurrence in float64 (the reference's
    ``tests/test_ssd_kernel.py::_ssd_reference``)."""
    x, bmat, cmat, da, dt = (np.asarray(a, np.float64)
                             for a in (x, bmat, cmat, da, dt))
    bsz, s, h, hd = x.shape
    state = np.zeros((bsz, h, hd, bmat.shape[-1]))
    y = np.zeros_like(x)
    for t in range(s):
        xdt = x[:, t] * dt[:, t][..., None]
        state = state * np.exp(da[:, t])[:, :, None, None] \
            + xdt[..., None] * bmat[:, t][:, None, None, :]
        y[:, t] = np.einsum("bhdn,bn->bhd", state, cmat[:, t])
    return y


def _inputs(s, h, hd, n, seed, bsz=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(0, 0.5, (bsz, s, h, hd)).astype(f),
            rng.normal(0, 0.5, (bsz, s, n)).astype(f),
            rng.normal(0, 0.5, (bsz, s, n)).astype(f),
            -rng.uniform(0, 0.5, (bsz, s, h)).astype(f),
            rng.uniform(0.1, 1.0, (bsz, s, h)).astype(f))


@pytest.mark.parametrize("s,h,hd,n,chunk", SHAPES)
def test_plain_ssd_scan_matches_pallas_and_recurrence(s, h, hd, n, chunk):
    xs = _inputs(s, h, hd, n, s + h)
    before = dict(kbuild.LAUNCHES)
    got = ssd.ssd_scan(*map(torch.as_tensor, xs), chunk=chunk).numpy()
    assert kbuild.LAUNCHES == before      # CPU tensors: the plain version
    pallas = np.asarray(jssd_scan(*map(jnp.asarray, xs), chunk=chunk))
    assert np.abs(got - pallas).max() < 1e-5
    assert np.abs(got - _recurrence(*xs)).max() < 5e-4


def passes_model(x, bmat, cmat, da, dt, chunk):
    """B9's four passes (``csrc/ssd_scan.cu``) in plain torch, float32:
    cum as a float64 scan rounded once; (g) gt[j, i] = B_j · C_i per
    (batch, chunk); (a) each chunk's (N, hd) state contribution
    Σ_j B_jᵀ (x_j dt_j exp(cum_last − cum_j)); (b) the states passed in chunk
    order, each slot the state before its chunk; (c) y = exp(cum) ∘ (C
    S_prevᵀ) + (Gᵀ ∘ L)(x dt).  Returns (y, final state (B, H, hd, N))."""
    b, s, h, hd = x.shape
    n, nc = bmat.shape[-1], s // chunk
    xc = x.reshape(b, nc, chunk, h, hd)
    bc, cc = bmat.reshape(b, nc, chunk, n), cmat.reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, h)
    cum = torch.cumsum(da.reshape(b, nc, chunk, h).double(), dim=2).float()
    gt = torch.einsum("bcjn,bcin->bcji", bc, cc)                   # (g)
    last = cum[:, :, -1]                                           # (b,nc,h)
    xdt = xc * dtc[..., None]
    tail = torch.exp(last[:, :, None] - cum)
    ds = torch.einsum("bcjn,bcjhd->bhcnd", bc, xdt * tail[..., None])  # (a)
    prev = torch.empty_like(ds)                                    # (b)
    state = torch.zeros((b, h, n, hd))
    for c in range(nc):
        prev[:, :, c] = state
        state = state * torch.exp(last[:, c])[:, :, None, None] + ds[:, :, c]
    mask = torch.ones((chunk, chunk), dtype=torch.bool).tril()     # (c)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]             # [i, j]
    decay = torch.where(mask[None, None, :, :, None], torch.exp(li), 0.0)
    m = gt.transpose(-1, -2)[..., None] * decay                    # [i, j]
    y = torch.einsum("bcin,bhcnd->bcihd", cc, prev) \
        * torch.exp(cum)[..., None] \
        + torch.einsum("bcijh,bcjhd->bcihd", m, xdt)
    return y.reshape(b, s, h, hd), state.transpose(-1, -2)


# the reference's kernel-test shapes, and Mamba2-1.3B's widths with 4 heads
MODEL_SHAPES = [(2,) + sh for sh in SHAPES] + [(1, 512, 4, 64, 128, 256)]


@pytest.mark.parametrize("bsz,s,h,hd,n,chunk", MODEL_SHAPES)
def test_passes_model_matches_chunked_and_pallas(bsz, s, h, hd, n, chunk):
    """The passes regroup the chunk math (the states of all chunks first,
    then every chunk's output), all float32: y and the final state within
    1e-6 of their scale of the plain version (``ssd_chunked``; measured
    ≤ 8.3e-8), y within 1e-5 of the Pallas kernel's in interpret mode
    (XLA's float32 products sum in another order; measured ≤ 2.3e-6)."""
    xs = _inputs(s, h, hd, n, s + h + n, bsz)
    ts = tuple(map(torch.as_tensor, xs))
    y, state = passes_model(*ts, chunk)
    want, wstate = ssd.ssd_chunked(*ts, chunk)
    assert _close(y, want.numpy(), 1e-6)
    assert _close(state, wstate.numpy(), 1e-6)
    pallas = np.asarray(jssd_scan(*map(jnp.asarray, xs), chunk=chunk))
    assert _close(y, pallas, 1e-5)


def test_ssd_scan_requires_whole_chunks():
    xs = map(torch.as_tensor, _inputs(48, 1, 16, 8, 0))
    with pytest.raises(AssertionError):
        ssd.ssd_scan(*xs, chunk=32)


def _cfgs(chunk=32):
    return (dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                                ssd_chunk=chunk),
            dataclasses.replace(ref_config("mamba2-1.3b").reduced(),
                                ssd_chunk=chunk))


def _mamba(cfg, rcfg, seed):
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), rcfg.d_model,
                          rcfg.mamba_expand, rcfg.mamba_head_dim,
                          rcfg.ssm_state, rcfg.mamba_d_conv)
    # A_log, dt_bias and D off their zero / one init, so every term counts
    rng = np.random.default_rng(seed)
    jp = {**jp, **{k: jnp.asarray(rng.uniform(lo, hi, jp[k].shape),
                                  jnp.float32)
                   for k, lo, hi in (("A_log", -1.0, 1.0),
                                     ("dt_bias", -1.0, 1.0),
                                     ("D", 0.5, 1.5))}}
    p = ssm.Mamba2(cfg.d_model, cfg.mamba_expand, cfg.mamba_head_dim,
                   cfg.ssm_state, cfg.mamba_d_conv, device="meta")
    p.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in jp.items()},
                      assign=True)
    return jp, p


def _close(got: torch.Tensor, want, rel: float) -> bool:
    want = torch.tensor(np.asarray(want, np.float32))
    return float((got.float() - want).abs().max()) \
        <= rel * float(want.abs().max())


def _within_bf16(got: torch.Tensor, want) -> bool:
    want = torch.tensor(np.asarray(want, np.float32))
    return bool(((got.float() - want).abs()
                 <= 2.0 ** -7 * want.abs() + 1e-6).all())


@pytest.mark.parametrize("s", [64, 50])     # whole chunks, and padded
def test_ssd_prefill_matches_reference(s):
    cfg, rcfg = _cfgs()
    jp, p = _mamba(cfg, rcfg, 0)
    u = np.random.default_rng(1).normal(0, 0.3, (2, s, cfg.d_model)) \
        .astype(np.float32)
    want, wstate = jssm.ssd_prefill(jp, jnp.asarray(u), rcfg)
    got, state = ssm.ssd_prefill(p, torch.as_tensor(u), cfg)
    assert got.shape == (2, s, cfg.d_model) and got.dtype == torch.bfloat16
    assert _close(got, want.astype(jnp.float32), 2.0 ** -7)
    assert _close(state, wstate, 1e-5)


def test_ssd_scan_matches_ssm_module_inputs():
    """The reference's ``test_ssd_kernel_matches_ssm_module``: the scan on
    the inputs the module feeds its chunk scan, against the recurrence."""
    cfg, rcfg = _cfgs()
    _, p = _mamba(cfg, rcfg, 2)
    u = torch.as_tensor(np.random.default_rng(3).normal(
        0, 0.3, (2, 64, cfg.d_model)).astype(np.float32))
    _, x, bmat, cmat, da, dt = ssm.ssd_inputs(p, u, cfg)
    xs = (x.float(), bmat.float(), cmat.float(), da, dt)
    got = ssd.ssd_scan(*xs, chunk=32).numpy()
    assert np.abs(got - _recurrence(*(t.numpy() for t in xs))).max() < 5e-4


def test_ssd_decode_matches_reference():
    """Five one-token steps from a zero cache: outputs, state, conv."""
    cfg, rcfg = _cfgs()
    jp, p = _mamba(cfg, rcfg, 4)
    d_inner = cfg.mamba_expand * cfg.d_model
    h = d_inner // cfg.mamba_head_dim
    shapes = {"state": ((2, h, cfg.mamba_head_dim, cfg.ssm_state),
                        np.float32),
              "conv": ((2, cfg.mamba_d_conv - 1, d_inner + 2 * cfg.ssm_state),
                       jnp.bfloat16)}
    jc = {k: jnp.zeros(s, dt) for k, (s, dt) in shapes.items()}
    c = {"state": torch.zeros(shapes["state"][0]),
         "conv": torch.zeros(shapes["conv"][0], dtype=torch.bfloat16)}
    us = np.random.default_rng(5).normal(0, 0.3, (2, 5, cfg.d_model)) \
        .astype(np.float32)
    for t in range(5):
        want, jc = jssm.ssd_decode(jp, jnp.asarray(us[:, t:t + 1]), jc, rcfg)
        got, c = ssm.ssd_decode(p, torch.as_tensor(us[:, t:t + 1]), c, cfg)
        assert _close(got, want.astype(jnp.float32), 2.0 ** -7)
        assert _close(c["state"], jc["state"], 1e-5)
        assert _within_bf16(c["conv"], jc["conv"])


@pytest.mark.parametrize("mutant", [False, True])
def test_jitter_source_patches_every_site(mutant):
    """``kernels/ssd_jitter.py`` finds each of its anchors once in
    ``csrc/ssd_scan.cu`` (a change to the source that moves one fails
    here, not on the card); the mutant drops exactly one barrier."""
    from repro_torch.kernels import ssd_jitter
    src = (kbuild.SOURCE_DIR / "ssd_scan.cu").read_text()
    out = ssd_jitter.jittered_source(mutant)
    calls = out.count("jitter(") - out.count("void jitter(") \
        - out.count("ssd_set_jitter(")
    assert calls == len(ssd_jitter.SITES) - 1 + 2   # sites 2 and 5 add two
    assert "ssd_set_jitter" in out
    assert out.count("__syncthreads();") \
        == src.count("__syncthreads();") - (1 if mutant else 0)
