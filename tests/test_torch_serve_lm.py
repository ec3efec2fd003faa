"""``serve_secure --model lm`` of the port on the CPU: the reference's CLI
contract (its ``--quick`` preset and token-parity check, the byte-exact
cost model, the argument errors, one build per bucket, the trace spans and
the latency histogram) and the reference's tokens at the same seeds."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import cost_model as jcost
from repro.core import secure_transformer as jst
from repro_torch.launch import serve_secure

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    paths = {k: str(d / f"{k}.json") for k in ("json", "trace", "metrics")}
    st = serve_secure.main(["--model", "lm", "--quick", "--device", "cpu",
                            "--json", paths["json"], "--trace",
                            paths["trace"], "--metrics-json",
                            paths["metrics"]])
    return st, paths


def test_quick_ledger_exact_and_tokens_at_parity(quick):
    st, _ = quick
    q = serve_secure.QUICK_LM
    assert (st["d"], st["heads"], st["blocks"], st["vocab"], st["bucket"],
            st["prompt"], st["gen"], st["queries"]) == (
        q["d"], q["heads"], q["blocks"], q["vocab"], 8, q["prompt_len"],
        q["gen"], 1)
    assert st["static_norm"] and st["customized"] and st["traces"] == 1
    # the reference's closed form, and so its ledger, byte for byte
    want = jcost.lm_step_cost(8, 16, 2, 32, 1, 16, JRING.nbytes,
                              customized=True, static_norm=True)
    assert (st["rounds_per_token"], st["comm_kb_per_token"]) == \
        (want.rounds, want.nbytes / 1e3)
    assert st["tokens"] == st["oracle_tokens"]
    assert st["launches_per_token"] == {}     # no kernel on the CPU


def test_quick_tokens_equal_reference_decode(quick):
    """The reference's decode steps at serving's seeds (lm from
    PRNGKey(seed + 1), keys split(PRNGKey(seed + 7), 3), the prompt from
    default_rng(seed)) choose the same greedy tokens."""
    st, _ = quick
    jlm, _ = jst.share_lm_params(jax.random.PRNGKey(1), 16, 16, 2, 32, 1,
                                 JRING)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    cache = jst.init_kv_cache(1, 2, 8, 8, JRING)
    seq = list(st["prompt_tokens"])
    assert seq == np.random.default_rng(0).integers(0, 16, 3).tolist()
    for p in range(len(seq)):
        lg, cache = jst.secure_decode_step(jlm, cache, jnp.asarray(seq[p]),
                                           jnp.asarray(p), keys, True, True)
    toks = []
    for p in range(3, 3 + st["gen"]):
        toks.append(int(np.argmax(np.asarray(lg))))
        if p == 3 + st["gen"] - 1:
            break
        lg, cache = jst.secure_decode_step(jlm, cache, jnp.asarray(toks[-1]),
                                           jnp.asarray(p), keys, True, True)
    assert toks == st["tokens"]


def test_quick_outputs(quick):
    st, paths = quick
    stats = json.load(open(paths["json"]))
    assert stats["tokens"] == st["tokens"] and stats["tok_per_s"] > 0
    trace = json.load(open(paths["trace"]))
    names = [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert "decode_compile[b8]" in names and "decode_step[b8]" in names
    assert "prefill[3]" in names and "warmup" in names
    metrics = json.load(open(paths["metrics"]))
    hist = [k for k in metrics["histograms"]
            if k.startswith("token_latency_seconds")]
    assert hist, metrics["histograms"].keys()
    assert st["attribution"].ledger_bytes == st["ledger"].nbytes


def test_rmsnorm_softmax_mode_on_cpu():
    """The default RMSNorm path under --softmax-attention, at the CLI's
    default widths."""
    st = serve_secure.main(["--model", "lm", "--device", "cpu",
                            "--softmax-attention", "--prompt", "2", "--gen",
                            "3", "--queries", "1", "--buckets", "8,16"])
    want = jcost.lm_step_cost(8, 32, 2, 64, 2, 32, JRING.nbytes,
                              customized=False)
    assert (st["rounds_per_token"], st["comm_kb_per_token"]) == \
        (want.rounds, want.nbytes / 1e3)
    assert st["bucket"] == 8 and not st["customized"]
    assert len(st["tokens"]) == 3 and st["logits"].shape == (4, 32)
    # the opened logits of every step follow the fp32 oracle
    from repro_torch.core.secure_transformer import plaintext_lm_forward
    want = plaintext_lm_forward(st["plain"], st["prompt_tokens"]
                                + st["tokens"][:-1], 2, False, 8)
    assert np.abs(st["logits"] - want).max() < 0.15


@pytest.mark.parametrize("argv", [
    ["--lm-d", "30", "--lm-heads", "4"],
    ["--prompt", "20", "--gen", "20", "--buckets", "16,32"],
    ["--buckets", "x"],
    ["--gen", "0"],
    ["--queries", "0"],
], ids=["heads", "bucket", "buckets-parse", "gen", "queries"])
def test_lm_argument_errors_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve_secure.main(["--model", "lm", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--quick", "--softmax-attention",
                                  "--static-norm"])
def test_lm_flags_require_model_lm(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve_secure.main([flag, "--device", "cpu"])
    assert e.value.code == 2
    assert "requires --model lm" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["lm", "bnn"])
def test_backend_mesh_raises(model, monkeypatch):
    """--backend mesh serves both models (test_torch_serve_mesh.py); with
    no card and no --device cpu it raises, as the local backend does,
    before any party process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_secure.main(["--model", model, "--backend", "mesh"])
