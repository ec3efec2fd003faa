"""The port's secure transformer block and secure LM decode == the JAX
package's: the same seeds give the same shares, logits, KV cache and ledger
rows, at the reference test's sizes (``tests/test_secure_transformer.py``:
vocab 16, d 16, 2 heads, d_ff 32, 1 block, bucket 8; the block at seq 8,
d 32).  The reference runs eagerly (one XLA compile per step would cost
minutes on the CPU); where the pinned property does not depend on the norm,
the static-norm customization keeps the reference's part short, as the
reference's own test does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import comm as jcomm
from repro.core import linear as jlinear
from repro.core import secure_transformer as jst
from repro.core.rss import share as jshare
from repro_torch.core import comm, prf, telemetry
from repro_torch.core import secure_transformer as st
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, reconstruct, share
from repro_torch.kernels import ops as kops
from repro_torch.weights import ring_from_numpy, ring_to_numpy

torch.set_num_threads(1)

VOCAB, D, HEADS, D_FF, BLOCKS = 16, 16, 2, 32, 1
BUCKET = 8
MODES = [(True, False), (False, False), (True, True), (False, True)]
MODE_IDS = ["custom-rms", "softmax-rms", "custom-static", "softmax-static"]


def _rows(led):
    return ((led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes),
            sorted((k, tuple(v)) for k, v in led.by_tag.items()))


def _same(j, t):
    assert np.array_equal(np.asarray(getattr(j, "shares", j)),
                          ring_to_numpy(getattr(t, "shares", t)))


@pytest.fixture(scope="module")
def lm_pair():
    jlm, jplain = jst.share_lm_params(jax.random.PRNGKey(0), VOCAB, D, HEADS,
                                      D_FF, BLOCKS, JRING)
    lm, plain = st.share_lm_params(prf.PRNGKey(0), VOCAB, D, HEADS, D_FF,
                                   BLOCKS, RING32, device="cpu")
    jkeys = jax.random.split(jax.random.PRNGKey(11), 3)
    keys = prf.split(prf.PRNGKey(11), 3)
    tokens = np.random.default_rng(5).integers(0, VOCAB, BUCKET - 1) \
        .astype(np.int32)
    return jlm, jplain, jkeys, lm, plain, keys, tokens


def _cache(lm):
    return st.init_kv_cache(lm.n_blocks, lm.n_heads, lm.head_dim, BUCKET,
                            RING32, device="cpu")


# ---------------------------------------------------------------------------
# Setup: the shares
# ---------------------------------------------------------------------------

def test_share_lm_params_identical(lm_pair):
    jlm, jplain, _, lm, plain, _, _ = lm_pair
    _same(jlm.embed, lm.embed)
    _same(jlm.gf, lm.gf)
    _same(jlm.w_out, lm.w_out)
    assert (lm.vocab, lm.n_heads, lm.head_dim, lm.n_blocks, lm.d_model) == \
        (jlm.vocab, jlm.n_heads, jlm.head_dim, jlm.n_blocks, jlm.d_model)
    for jb, tb, jp, tp in zip(jlm.blocks, lm.blocks, jplain["blocks"],
                              plain["blocks"]):
        for f in st.SecureBlockParams._FIELDS:
            _same(getattr(jb, f), getattr(tb, f))
            assert np.array_equal(jp[f], tp[f])
        assert tb.limbs is None            # the CPU runs the plain products
    assert lm.w_out_limbs is None
    for f in ("embed", "gf", "w_out"):
        assert np.array_equal(jplain[f], plain[f])


def test_share_block_params_identical():
    jbp, jplain = jst.share_block_params(jax.random.PRNGKey(0), 32, 2, 64)
    bp, plain = st.share_block_params(prf.PRNGKey(0), 32, 2, 64,
                                      device="cpu")
    assert (bp.n_heads, bp.head_dim) == (jbp.n_heads, jbp.head_dim) == (2, 16)
    for f in st.SecureBlockParams._FIELDS:
        _same(getattr(jbp, f), getattr(bp, f))
        assert np.array_equal(jplain[f], plain[f])


# ---------------------------------------------------------------------------
# The batched product (B5's batched entry) and _bmm
# ---------------------------------------------------------------------------

def test_batched_b5_plain_equals_reference_einsum():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (3, 2, 4, 16), dtype=np.uint64) \
        .astype(np.uint32)
    b = rng.integers(0, 2**32, (3, 2, 16, 8), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.stack([np.asarray(jnp.einsum(
        "hsk,hkt->hst", jnp.asarray(a[i]), jnp.asarray(b[i]),
        preferred_element_type=jnp.uint32)) for i in range(3)])
    got = kops.ring_matmul_batched_op(ring_from_numpy(a), ring_from_numpy(b))
    assert np.array_equal(ring_to_numpy(got), want)


@pytest.mark.parametrize("fuse,fused", [(False, True), (True, True),
                                        (True, False)],
                         ids=["reshare", "fused", "paper"])
def test_bmm_identical(fuse, fused):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 3, 8)).astype(np.float32)
    y = rng.normal(0, 1, (2, 8, 5)).astype(np.float32)
    jlinear.set_fused_rounds(fused)
    try:
        jx = jshare(x, jax.random.PRNGKey(1))
        jy = jshare(y, jax.random.PRNGKey(2))
        with jcomm.track() as jl:
            jo = jst._bmm(jx, jy, JParties.setup(jax.random.PRNGKey(3)),
                          "bm", fuse_trunc=fuse)
    finally:
        jlinear.set_fused_rounds(True)
    from repro_torch.core import linear
    linear.set_fused_rounds(fused)
    try:
        tx, ty = share(torch.from_numpy(x), prf.PRNGKey(1)), \
            share(torch.from_numpy(y), prf.PRNGKey(2))
        with comm.track() as tl:
            to = st._bmm(tx, ty, Parties.setup(prf.PRNGKey(3)), "bm",
                         fuse_trunc=fuse)
    finally:
        linear.set_fused_rounds(True)
    _same(jo, to)
    assert _rows(tl) == _rows(jl)


# ---------------------------------------------------------------------------
# secure_block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_pair():
    jbp, plain = jst.share_block_params(jax.random.PRNGKey(0), 32, 2, 64)
    bp, _ = st.share_block_params(prf.PRNGKey(0), 32, 2, 64, device="cpu")
    x = np.random.default_rng(1).normal(0, 0.5, (8, 32)).astype(np.float32)
    return (jbp, jshare(x, jax.random.PRNGKey(2)), bp,
            share(torch.from_numpy(x), prf.PRNGKey(2)), plain, x)


@pytest.mark.parametrize("customized,static_norm", MODES, ids=MODE_IDS)
def test_secure_block_identical(block_pair, customized, static_norm):
    jbp, jx, bp, tx, plain, x = block_pair
    with jcomm.track() as jl:
        jo = jst.secure_block(jx, jbp, JParties.setup(jax.random.PRNGKey(3)),
                              customized, static_norm)
    with comm.track() as tl:
        to = st.secure_block(tx, bp, Parties.setup(prf.PRNGKey(3)),
                             customized, static_norm)
    _same(jo, to)
    assert _rows(tl) == _rows(jl)
    # the reference test's bounds against the fp32 oracle
    want = st.plaintext_block(x, plain, 2, customized, static_norm)
    assert np.array_equal(want, jst.plaintext_block(x, plain, 2, customized,
                                                    static_norm))
    tol = 0.05 if customized else 0.12
    assert np.abs(reconstruct(to).numpy() - want).max() < tol


# ---------------------------------------------------------------------------
# secure_decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("customized,static_norm", MODES, ids=MODE_IDS)
def test_decode_step_identical(lm_pair, customized, static_norm):
    """Logits, the ledger rows of every step and the KV cache after each
    step equal the reference's, over the first positions of a prompt."""
    jlm, _, jkeys, lm, _, keys, tokens = lm_pair
    jc = jst.init_kv_cache(BLOCKS, HEADS, D // HEADS, BUCKET, JRING)
    tc = _cache(lm)
    for p in range(2):
        with jcomm.track() as jl:
            jlg, jc = jst.secure_decode_step(
                jlm, jc, jnp.asarray(int(tokens[p])), jnp.asarray(p), jkeys,
                customized, static_norm)
        with comm.track() as tl:
            lg, tc = st.secure_decode_step(lm, tc, int(tokens[p]), p, keys,
                                           customized, static_norm)
        assert lg.dtype == torch.float32 and lg.shape == (VOCAB,)
        assert np.array_equal(np.asarray(jlg), lg.numpy()), p
        assert _rows(tl) == _rows(jl)
        _same(jc.k, tc.k)
        _same(jc.v, tc.v)


def test_prefill_then_decode_bit_identity(lm_pair):
    """The full prefill and prefill-then-decode (a prompt prefix, then one
    built step a remaining token) give bit-identical logits at every
    position and bit-identical caches; the run tracks the fp32 oracle."""
    _, _, _, lm, plain, keys, tokens = lm_pair
    lg_full, cache_full = st.secure_prefill(lm, _cache(lm), tokens, keys,
                                            static_norm=True)
    step = st.CompiledDecodeStep(lm, customized=True, static_norm=True)
    split = 3
    lg_pre, cache = st.scan_prefill(step.raw, _cache(lm), tokens[:split],
                                    keys)
    got = [lg_pre]
    for p in range(split, len(tokens)):
        lg, cache = step(cache, int(tokens[p]), p, keys)
        got.append(lg[None])
    got = torch.cat(got)
    assert torch.equal(got, lg_full)
    assert torch.equal(cache.k, cache_full.k)
    assert torch.equal(cache.v, cache_full.v)
    assert step.traces == 1
    oracle = st.plaintext_lm_forward(plain, tokens, HEADS, True, BUCKET,
                                     static_norm=True)
    assert np.abs(lg_full.numpy() - oracle).max() < 0.06


def test_prefill_equals_reference_decode_loop(lm_pair):
    """The port's prefill == the reference's per-token decode steps (its
    scanned prefill is pinned to them bit for bit by its own test)."""
    jlm, _, jkeys, lm, _, keys, tokens = lm_pair
    lg, cache = st.secure_prefill(lm, _cache(lm), tokens[:3], keys,
                                  customized=False, static_norm=True)
    jc = jst.init_kv_cache(BLOCKS, HEADS, D // HEADS, BUCKET, JRING)
    for p in range(3):
        jlg, jc = jst.secure_decode_step(jlm, jc, jnp.asarray(int(tokens[p])),
                                         jnp.asarray(p), jkeys, False, True)
        assert np.array_equal(np.asarray(jlg), lg[p].numpy()), p
    _same(jc.k, cache.k)
    _same(jc.v, cache.v)


def test_decode_builds_once_per_bucket(lm_pair):
    """One build per cache bucket length however many (token, position)
    pairs stream through; a new bucket builds once more; replays at both
    buckets build nothing.  Under a tracer the building call's span is
    decode_compile[bN], the others decode_step[bN]."""
    _, _, _, lm, _, keys, tokens = lm_pair
    step = st.CompiledDecodeStep(lm, customized=True, static_norm=True,
                                 bucket=BUCKET)
    tracer = telemetry.Tracer()
    cache = _cache(lm)
    with telemetry.tracing(tracer):
        for p in range(3):
            _lg, cache = step(cache, int(tokens[p]), p, keys)
    assert step.traces == 1, step.traces
    assert [s.name for s in tracer.spans] == \
        [f"decode_compile[b{BUCKET}]"] + [f"decode_step[b{BUCKET}]"] * 2
    assert [s.cat for s in tracer.spans] == ["compile", "online", "online"]

    wide = st.init_kv_cache(lm.n_blocks, lm.n_heads, lm.head_dim, 12, RING32,
                            device="cpu")
    for p in range(2):
        _lg, wide = step(wide, int(tokens[p]), p, keys)
    assert step.traces == 2, step.traces

    step(cache, 0, 3, keys)
    step(wide, 0, 2, keys)
    assert step.traces == 2, step.traces


@pytest.mark.parametrize("customized", [True, False],
                         ids=["custom", "softmax"])
def test_decode_rollout_matches_oracle(lm_pair, customized):
    """Greedy rollout over the full default path (RMSNorm included):
    token-identical to the fp32 oracle at every position, logits inside
    the reference test's fixed-point envelope."""
    _, _, _, lm, plain, keys, tokens = lm_pair
    tol = 0.06 if customized else 0.15
    cache = _cache(lm)
    seq = list(map(int, tokens[:3]))
    for p in range(len(seq)):
        lg, cache = st.secure_decode_step(lm, cache, seq[p], p, keys,
                                          customized)
    lg = lg.numpy()
    for p in range(len(seq), BUCKET):
        oracle = st.plaintext_lm_forward(plain, np.asarray(seq, np.int32),
                                         HEADS, customized, BUCKET)[-1]
        assert np.abs(lg - oracle).max() < tol, (p, np.abs(lg - oracle).max())
        nxt = int(np.argmax(lg))
        assert nxt == int(np.argmax(oracle)), (p, lg, oracle)
        if p == BUCKET - 1:
            break
        seq.append(nxt)
        lg, cache = st.secure_decode_step(lm, cache, nxt, p, keys,
                                          customized)
        lg = lg.numpy()


def test_plaintext_lm_forward_identical(lm_pair):
    _, jplain, _, _, plain, _, tokens = lm_pair
    for customized in (True, False):
        for static_norm in (True, False):
            assert np.array_equal(
                st.plaintext_lm_forward(plain, tokens, HEADS, customized,
                                        BUCKET, static_norm),
                jst.plaintext_lm_forward(jplain, tokens, HEADS, customized,
                                         BUCKET, static_norm))


# ---------------------------------------------------------------------------
# block_comm_profile; what waits for A7
# ---------------------------------------------------------------------------

def test_block_comm_profile_identical():
    try:
        want = jst.block_comm_profile()
    finally:
        jlinear.set_fused_rounds(True)   # the reference leaves it off
    from repro_torch.core import linear
    got = st.block_comm_profile()
    assert linear.fused_rounds() and linear._MATMUL_MODE == "opt2"
    assert sorted(got) == sorted(want)
    for name in want:
        assert _rows(got[name]) == _rows(want[name]), name


def test_mesh_layout_raises():
    with pytest.raises(NotImplementedError, match="A7"):
        st.make_secure_lm_mesh(None, None)
    with pytest.raises(NotImplementedError, match="A7"):
        st.init_kv_cache(1, 2, 8, 8, RING32, slots=6, device="cpu")


def test_decode_step_meta_ledger_equals_live(lm_pair):
    """The shape-only ledger (what serving checks against the cost model)
    equals a live step's."""
    _, _, _, lm, _, keys, tokens = lm_pair
    meta = comm.estimate_cost(
        lambda m, c: st.secure_decode_step(m, c, 0, 0, keys), lm, _cache(lm))
    with comm.track() as live:
        st.secure_decode_step(lm, _cache(lm), int(tokens[0]), 0, keys)
    assert _rows(meta) == _rows(live)
    assert isinstance(lm.embed, RSS) and lm.embed.shares.device.type == "cpu"
