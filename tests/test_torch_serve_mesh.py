"""``serve_secure --backend mesh`` on the CPU (``--device cpu``): three
gloo ranks serve the classifier inline, from the tape pool under
``--verify full``, and the secure LM, with the local backend's logits and
tokens; the wire of the three ranks equals the ledger (online + offline
inline, online under the pool).  (Without a card and without
``--device cpu`` the mesh raises: test_torch_serve_lm.py.)  Imports
neither JAX nor the reference package."""
import numpy as np
import torch

from repro_torch.launch import serve_secure

torch.set_num_threads(1)

NET = "MnistNet1"


def test_cli_mesh_inline_equals_local():
    loc = serve_secure.serve(NET, 2, 1, device="cpu")
    st = serve_secure.main(["--net", NET, "--batch", "2", "--queries", "2",
                            "--device", "cpu", "--backend", "mesh"])
    assert st["backend"] == "mesh"
    assert np.array_equal(st["logits"], loc["logits"])
    assert (st["online_rounds"], st["online_bytes"]) \
        == (loc["online_rounds"], loc["online_bytes"])
    assert st["wire_bytes"] == st["ledger_bytes"] \
        == loc["online_bytes"] + loc["offline_bytes"]
    assert len(st["rank_wire_bytes"]) == 3 and st["wire_rel_diff"] == 0


def test_cli_mesh_pool_verified(tmp_path):
    """--offline pool --verify full: the tape-backed ranks evaluate no
    PRF, put the online ledger's bytes on the wire exactly, and open the
    local pool run's logits; the trace has one lane a party."""
    loc = serve_secure.serve(NET, 2, 2, device="cpu", offline="pool",
                             pool_depth=2)
    trace = tmp_path / "t.json"
    st = serve_secure.main(["--net", NET, "--batch", "2", "--queries", "2",
                            "--device", "cpu", "--backend", "mesh",
                            "--offline", "pool", "--pool-depth", "2",
                            "--verify", "full", "--trace", str(trace)])
    assert np.array_equal(st["logits"], loc["logits"])
    assert st["rank_prf_calls_per_query"] == [0, 0, 0]
    assert st["wire_bytes"] == st["wire_online_bytes"] \
        == st["online_bytes"] > 0
    assert st["verified_ops"] > 0 and st["refills"] == loc["refills"]
    import json
    lanes = {e["args"]["name"] for e in json.loads(trace.read_text())
             ["traceEvents"] if e.get("ph") == "M"}
    assert {"party0", "party1", "party2"} <= lanes


def test_cli_mesh_lm_equals_local():
    kw = dict(d=16, heads=2, d_ff=32, blocks=1, vocab=16, prompt_len=2,
              gen=2, buckets=(8,), queries=1, device="cpu")
    loc = serve_secure.serve_lm(**kw)
    st = serve_secure.serve_lm(**kw, backend="mesh")
    assert st["tokens"] == loc["tokens"]
    assert np.array_equal(st["logits"], loc["logits"])
    k, v = st["cache"]
    assert torch.equal(k[0::2], loc["cache"].k)
    assert torch.equal(v[1::2], torch.roll(loc["cache"].v, -1, dims=0))
    assert st["wire_bytes_per_step"] == st["ledger_bytes_per_step"]
