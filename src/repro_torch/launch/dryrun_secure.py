"""Secure-plane check at LM widths: one secure FFN pair (Alg. 2 matmul,
Π_trunc, ReLU, Alg. 2 matmul, Π_trunc) over shares (3, T, d), in the
paper's 3-product Algorithm 2 ("paper3") against the fused-operand
2-product form ("opt2").

Port of ``repro/launch/dryrun_secure.py`` (``build_step``, ``run``).  The
reference counts the ring-matmul FLOPs of the two modes in the compiled
HLO of a 256-chip program.  The port has no HLO: it runs the pair and
counts the ring products themselves, through the protocols' per-party
``dot`` (``kernels.ops.rss_matmul_dot``: one product, one launch of the
ring-matmul kernel B5 on the card, its plain version on the CPU): 9 a
secure matmul under "paper3", 6 under "opt2", so the products and their
multiply-adds stand at exactly 1.5 : 1, and the launches of B5 in
``kbuild.LAUNCHES`` agree on the card.  The ledger of the two modes is
the same (the modes differ only in local products).  It also runs the
pair on the deployed route, the weights' cached limbs (one launch of B1
a matmul, the fused operand whatever the mode), and on the card times
every route: host clock around synchronised steps.

``set_matmul_mode`` is a process global: it is restored as found.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_secure \\
      [--tokens 2048] [--d 4096] [--d-ff 14336] [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..core import comm, linear, prf
from ..core.activation import secure_relu
from ..core.randomness import Parties
from ..core.ring import RING32
from ..core.rss import share
from ..device import resolve_device

__all__ = ["build_step", "run", "main"]

MODES = ("paper3", "opt2")
# per-party products of one secure matmul, the three parties together
PRODUCTS = {"paper3": 9, "opt2": 6}


def build_step(dot=None, limbs: tuple | None = None):
    """``step(parties, x, w1, w2) -> out RSS``: the FFN pair; the products
    through ``dot`` (per party) or, with ``limbs`` (the two weights'
    ``WeightLimbs``), the fused kernel."""
    l1, l2 = limbs if limbs is not None else (None, None)

    def step(parties, x, w1, w2):
        h = linear.truncate(linear.matmul(x, w1, parties, tag="ffn.up",
                                          w_limbs=l1, dot=dot), parties)
        h = secure_relu(h, parties, tag="ffn.relu")
        return linear.truncate(linear.matmul(h, w2, parties, tag="ffn.down",
                                             w_limbs=l2, dot=dot), parties)
    return step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(tokens: int, d: int, d_ff: int, device=None, reps: int = 2,
        out_dir: str | None = None) -> dict:
    """Run the pair in both modes and on the fused route; returns each
    mode's products, multiply-adds, B5 launches, ledger and seconds, the
    fused route's B1 launches and seconds, and the paper3 / opt2 ratios
    (``paper3_over_opt2_products`` must be 1.5)."""
    from ..kernels import build as kbuild
    from ..kernels.ops import rss_matmul_dot
    from ..kernels.rss_matmul import precompute_weight_limbs
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def shares(shape, scale, key):
        return share(torch.as_tensor(rng.normal(0, scale, shape)
                                     .astype(np.float32), device=dev),
                     prf.PRNGKey(key), RING32)
    x = shares((tokens, d), 1.0, 1)
    w1 = shares((d, d_ff), d ** -0.5, 2)
    w2 = shares((d_ff, d), d_ff ** -0.5, 3)
    key = prf.PRNGKey(7)

    found = linear._MATMUL_MODE
    counted = {"products": 0, "macs": 0}

    def dot(a, b):
        counted["products"] += 1
        counted["macs"] += a.numel() // a.shape[-1] * a.shape[-1] \
            * b.shape[-1]
        return rss_matmul_dot(a, b)

    def timed(step, mode):
        linear.set_matmul_mode(mode)
        counted.update(products=0, macs=0)
        launches0 = dict(kbuild.LAUNCHES)
        with comm.track() as led:
            out = step(Parties.setup(key, device=dev), x, w1, w2)
        _sync(dev)
        rec = {"products": counted["products"], "macs": counted["macs"],
               "launches": {k: c - launches0[k]
                            for k, c in kbuild.LAUNCHES.items()
                            if c != launches0[k]},
               "ledger": {"rounds": led.rounds, "bytes": led.nbytes,
                          "pre_rounds": led.pre_rounds,
                          "pre_bytes": led.pre_nbytes}}
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(Parties.setup(key, device=dev), x, w1, w2)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        rec["seconds"] = secs
        return rec, out

    results = {"tokens": tokens, "d": d, "d_ff": d_ff, "device": str(dev)}
    try:
        outs = {}
        for mode in MODES:
            results[mode], outs[mode] = timed(build_step(dot), mode)
        limbs = (precompute_weight_limbs(w1.shares),
                 precompute_weight_limbs(w2.shares))
        results["fused"], outs["fused"] = timed(build_step(limbs=limbs),
                                                "opt2")
    finally:
        linear.set_matmul_mode(found)
    for mode in MODES:
        want = 2 * PRODUCTS[mode]
        if results[mode]["products"] != want:
            raise RuntimeError(f"{mode}: {results[mode]['products']} ring "
                               f"products, the protocol makes {want}")
    if results["paper3"]["ledger"] != results["opt2"]["ledger"]:
        raise RuntimeError("the two matmul modes sent different messages")
    # the same shares and keys: every route opens the same values
    for mode in ("opt2", "fused"):
        if not torch.equal(outs[mode].shares, outs["paper3"].shares):
            raise RuntimeError(f"{mode} computed other shares than paper3")
    results["paper3_over_opt2_products"] = \
        results["paper3"]["products"] / results["opt2"]["products"]
    results["paper3_over_opt2_macs"] = \
        results["paper3"]["macs"] / results["opt2"]["macs"]
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(exist_ok=True, parents=True)
        (out / "secure_ffn_scale.json").write_text(
            json.dumps(results, indent=2))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--d-ff", type=int, default=14336)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.tokens, args.d, args.d_ff, args.device, args.reps,
              args.out)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
