"""BENCHMARK.json and the files it names: every cell and metric resolves by
name, the file keeps to the benchmark contract's form, and a new
configuration, cell and metric are new files and entries alone."""
import hashlib
import json
import re
import shutil

import pytest

from cbnn_bench.harness import manifest, serve

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    w, cfg, traffic = manifest.cell(BENCH, cell)
    assert cfg["name"] == w["config"] and traffic["batch"] >= 1
    assert traffic["offline"] in ("inline", "pool")
    assert traffic["weights"] in ("shared", "public")
    serve._check_traffic(traffic)
    for kind in ("end_to_end", "per_layer"):
        assert manifest.metrics_for(BENCH, cell, kind)
    names = [m["name"] for m in manifest.metrics_for(BENCH, cell,
                                                     "end_to_end")]
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("extra", [{"clients": 4}, {"arrival_rate": 10.0},
                                   {"pool_depth": 8}])
def test_unread_traffic_key_is_refused(extra):
    """A traffic key that the window does not read stops the run, so that
    no knob can be set in data alone and silently ignored."""
    _, _, traffic = manifest.cell(BENCH, "cifarnet2-inline-b256")
    with pytest.raises(ValueError, match="does not read"):
        serve._check_traffic({**traffic, **extra})


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_resolves(metric):
    mod = manifest.load_metric(metric)
    assert callable(mod.read) and mod.READS


def test_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cbnn_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cbnn_bench/")
        assert (manifest.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 65536


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "cbnn_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a metric: new files and new entries, no edit of a file."""
    shutil.copytree(manifest.ROOT / "cbnn_bench", tmp_path / "cbnn_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    pkg = tmp_path / "cbnn_bench"
    cfg = json.loads((pkg / "configs" / "cifarnet2.json").read_text())
    cfg["name"] = "cifarnet2-wide"
    (pkg / "configs" / "cifarnet2-wide.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "inline-b64.json").write_text(json.dumps(
        {**json.loads((pkg / "traffic" / "inline-b256.json").read_text()),
         "batch": 64}))
    (pkg / "metrics" / "queries_done.py").write_text(
        'READS = ("queries",)\n\n\ndef read(rec):\n'
        '    return rec["queries"]\n')
    bench["configs"].append({"name": "cifarnet2-wide", "source": "x",
                             "file": "cbnn_bench/configs/cifarnet2-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cifarnet2-wide-inline-b64",
                               "config": "cifarnet2-wide",
                               "traffic": "inline-b64", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "queries_done", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving", "moves": "images_per_s",
                               "workloads": ["cifarnet2-wide-inline-b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())
    loaded = manifest.load(tmp_path)
    w, c, t = manifest.cell(loaded, "cifarnet2-wide-inline-b64", tmp_path)
    assert c["name"] == "cifarnet2-wide" and t["batch"] == 64
    got = [m["name"] for m in manifest.metrics_for(
        loaded, "cifarnet2-wide-inline-b64", "per_layer")]
    assert got == ["queries_done"]
    assert manifest.load_metric("queries_done", tmp_path).read(
        {"queries": 7}) == 7
