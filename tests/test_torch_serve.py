"""The port's serving entry point, its device rule, and its independence
from JAX and from the reference package."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.launch import serve_secure

ROOT = Path(__file__).resolve().parent.parent


def test_serve_mnistnet1_on_cpu(tmp_path, capsys):
    out = tmp_path / "stats.json"
    before = dict(kbuild.LAUNCHES)
    st = serve_secure.main(["--net", "MnistNet1", "--batch", "2",
                            "--queries", "2", "--device", "cpu",
                            "--json", str(out)])
    assert st["logits"].shape == (2, 10)
    assert np.isfinite(st["logits"]).all()
    # the pinned per-query ledger of MnistNet1 at batch 2
    assert (st["online_rounds"], st["online_bytes"]) == (6, 2 * 10_992)
    assert (st["offline_rounds"], st["offline_bytes"]) == (8, 2 * 9_216)
    assert kbuild.LAUNCHES == before   # CPU tensors: the plain versions
    stats = json.loads(out.read_text())
    assert stats["device"] == "cpu" and stats["query_per_s"] > 0
    printed = capsys.readouterr().out
    assert "q/s" in printed and "kernel launches per query" in printed


def test_serve_public_weights_on_cpu(tmp_path, capsys):
    """--weights public: the public ledger of MnistNet1 (DESIGN.md §11,
    7.80 KB and 4 rounds a query at batch 1), named in the printed line
    and the stats."""
    out = tmp_path / "stats.json"
    st = serve_secure.main(["--weights", "public", "--binary-linear", "auto",
                            "--net", "MnistNet1", "--batch", "2",
                            "--queries", "1", "--device", "cpu",
                            "--json", str(out)])
    assert st["logits"].shape == (2, 10) and np.isfinite(st["logits"]).all()
    assert (st["online_rounds"], st["online_bytes"]) == (4, 2 * 7_800)
    assert (st["offline_rounds"], st["offline_bytes"]) == (8, 2 * 9_216)
    stats = json.loads(out.read_text())
    assert (stats["weights"], stats["binary_linear"]) == ("public", "auto")
    assert "weights=public binary_linear=auto" in capsys.readouterr().out
    with pytest.raises(SystemExit):   # argparse refuses an unknown mode
        serve_secure.main(["--weights", "private", "--device", "cpu"])


def test_serve_relu_net_on_cpu():
    """The ReLU teacher MnistNet4 through the entry point: its batch-1
    ledger is 1/32 of the pinned batch-32 rows (test_torch_secure_relu)."""
    st = serve_secure.main(["--net", "MnistNet4", "--batch", "1",
                            "--queries", "1", "--device", "cpu"])
    assert st["logits"].shape == (1, 10) and np.isfinite(st["logits"]).all()
    assert (st["online_rounds"], 32 * st["online_bytes"]) == (23, 105_762_048)


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_secure.main(["--net", "MnistNet1", "--batch", "1"])
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"
