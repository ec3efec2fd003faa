"""End-to-end CBNN customization pipeline (DESIGN.md §13):

    distill  -->  binarize  -->  compile_secure  -->  accuracy-vs-comm

Port of ``repro/distill/pipeline.py`` (``FAMILIES``, ``MODES``,
``PipelineRow``, ``_mark_pareto``, ``_secure_accuracy``,
``run_pipeline``), with a ``device`` argument (the card unless "cpu").
One call to :func:`run_pipeline` trains a full-precision teacher per
dataset family (MnistNet4 / CifarNet7), distills every student variant
through ``kd.train_bnn`` (eq. 5 loss), feeds the trained params through
``compile_secure`` in each weight/path mode of the §11 taxonomy, and
returns the accuracy-vs-online-bytes rows of the paper's customization
claim (Figs. 5/6 shape).  The secure accuracy draws its keys as the
reference does (``PRNGKey(seed)`` to share the weights, ``fold_in(PRNGKey
(7), i)`` a batch's parties, ``PRNGKey(9)`` the input's shares), so on the
same params its secure logits equal the reference's bit for bit.

Data is synthetic (offline, DESIGN.md §9): accuracies separate variants
relatively; they are NOT the paper's MNIST/CIFAR numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core import prf
from ..core.comm import LAN, WAN
from ..core.randomness import Parties
from ..core.ring import RING32
from ..core.rss import share
from ..core.secure_model import (compile_secure, post_sign_linear_cost,
                                 secure_infer, secure_infer_cost)
from ..data import image_dataset
from ..device import resolve_device
from ..nn import bnn
from .kd import train_bnn

__all__ = ["FAMILIES", "MODES", "PipelineRow", "run_pipeline"]

# student variants: (net, conv kind); teachers are trained once per family
# and shared by every student in it
FAMILIES = {
    "mnist": {"data": "mnist-syn", "teacher": "MnistNet4",
              "students": [("MnistNet1", "dense"),
                           ("MnistNet2", "dense"),
                           ("MnistNet3", "dense"),
                           ("MnistNet3-sep", "separable")]},
    "cifar": {"data": "cifar-syn", "teacher": "CifarNet7",
              "students": [("CifarNet1", "dense"),
                           ("CifarNet2", "separable")]},
}

# §11 weight/path modes: compile_secure kwargs per mode label
MODES = {
    "shared": {},                           # bin-shared engine (default)
    "arith": {"binary_linear": "off"},      # binarization-unaware ablation
    "public": {"weights": "public"},        # public-model deployment
}


@dataclasses.dataclass
class PipelineRow:
    net: str
    family: str
    conv: str           # "dense" | "separable"
    mode: str           # "shared" | "arith" | "public"
    acc: float          # plaintext eval-mode accuracy (synthetic test set)
    secure_acc: float | None   # secure accuracy on the eval subset
    params: int
    online_kb: float    # total online wire bytes / query, KB
    rounds: int
    postsign_kb: float  # online KB on the binary_in linear layers (§11)
    lan_s: float
    wan_s: float
    pareto: bool = False

    def as_dict(self):
        return dataclasses.asdict(self)


def _mark_pareto(rows: list[PipelineRow]) -> None:
    """Within each mode, flag the accuracy-vs-online-bytes frontier: a row
    is Pareto iff no other row has both higher accuracy and fewer bytes."""
    for mode in {r.mode for r in rows}:
        grp = [r for r in rows if r.mode == mode]
        for r in grp:
            r.pareto = not any(o.acc > r.acc and o.online_kb < r.online_kb
                               for o in grp if o is not r)


def _secure_accuracy(params, net, x, y, *, mode_kw, seed=5,
                     batch: int = 16) -> float:
    """Top-1 accuracy of the SECURE pipeline on numpy (x, y), on the
    params' device: the paper's own metric (Table 1 Acc column), run by
    the stacked three-party simulation."""
    dev = next(iter(params.values())).device
    model = compile_secure(params, net, prf.PRNGKey(seed), RING32, **mode_kw)
    correct = 0
    for i in range(0, len(x), batch):
        xb = torch.as_tensor(np.asarray(x[i:i + batch]), device=dev)
        parties = Parties.setup(prf.fold_in(prf.PRNGKey(7), i), device=dev)
        out = secure_infer(model, share(xb, prf.PRNGKey(9), RING32),
                           parties)
        correct += int((np.argmax(out.cpu().numpy(), -1)
                        == y[i:i + batch]).sum())
    return correct / len(x)


def run_pipeline(*, epochs: int = 2, batch: int = 128, lam: float = 0.1,
                 temperature: float = 10.0, seed: int = 0,
                 train_size: int | None = None, test_size: int | None = None,
                 secure_eval_size: int | None = 64,
                 families: Sequence[str] = ("mnist", "cifar"),
                 modes: Sequence[str] = ("shared", "arith", "public"),
                 verbose: bool = True, device=None) -> dict:
    """Run the full distill -> binarize -> compile_secure sweep on
    ``device``.

    Returns ``{"meta": {...}, "rows": [row-dict, ...]}``, the reference's
    BENCH_pareto.json payload.  ``train_size``/``test_size`` subset the
    synthetic data; ``secure_eval_size`` bounds the secure-accuracy
    evaluation (positive: "shared" mode only; negative: every mode; 0 or
    None: skipped)."""
    dev = resolve_device(device)
    rows: list[PipelineRow] = []
    log = print if verbose else (lambda *a, **k: None)
    for fam in families:
        cfg = FAMILIES[fam]
        data = image_dataset(cfg["data"], seed=3)
        if train_size or test_size:
            x_tr, y_tr, x_te, y_te = data
            data = (x_tr[:train_size], y_tr[:train_size],
                    x_te[:test_size], y_te[:test_size])
        log(f"== {fam}: teacher {cfg['teacher']} (full precision) ==")
        teacher = train_bnn(cfg["teacher"], data, epochs=epochs, batch=batch,
                            binarize=False, seed=seed, device=dev)
        log(f"   teacher acc {teacher.history[-1][2]:.3f}")
        for net, conv in cfg["students"]:
            log(f"-- student {net} ({conv}) + KD --")
            res = train_bnn(net, data, epochs=epochs, batch=batch, lam=lam,
                            temperature=temperature,
                            teacher=(teacher.params, cfg["teacher"]),
                            seed=seed, device=dev)
            acc = res.history[-1][2]
            shape = bnn.INPUT_SHAPES[net]
            for mode in modes:
                model = compile_secure(res.params, net, prf.PRNGKey(seed + 1),
                                       RING32, **MODES[mode])
                led = secure_infer_cost(model, (1,) + shape)
                ps_b, _ = post_sign_linear_cost(model, led)
                sec_acc = None
                if secure_eval_size and (mode == "shared"
                                         or secure_eval_size < 0):
                    n = abs(secure_eval_size)
                    sec_acc = _secure_accuracy(
                        res.params, net, data[2][:n], data[3][:n],
                        mode_kw=MODES[mode], seed=seed + 2)
                rows.append(PipelineRow(
                    net=net, family=fam, conv=conv, mode=mode, acc=acc,
                    secure_acc=sec_acc, params=res.param_count,
                    online_kb=led.nbytes / 1e3, rounds=led.rounds,
                    postsign_kb=ps_b / 1e3,
                    lan_s=led.time(LAN), wan_s=led.time(WAN)))
                log(f"   {mode:7s}: {led.nbytes / 1e3:9.1f} KB  "
                    f"rounds={led.rounds:3d}  acc={acc:.3f}"
                    + (f"  secure_acc={sec_acc:.3f}" if sec_acc is not None
                       else ""))
    _mark_pareto(rows)
    meta = {"epochs": epochs, "batch": batch, "lam": lam,
            "temperature": temperature, "seed": seed,
            "train_size": train_size, "test_size": test_size,
            "families": list(families), "modes": list(modes),
            "device": str(dev),
            "data": "synthetic (offline, DESIGN.md §9): accuracies are "
                    "relative, not paper MNIST/CIFAR numbers",
            "online_kb": "total online wire bytes per 1-query batch "
                         "(CommLedger, preprocessing excluded)"}
    return {"meta": meta, "rows": [r.as_dict() for r in rows]}
