"""The frozen count of a secure query's ring products, from the net's
layers at the batch.

Every linear layer of the secure classifier is one product launch a weight
part over the three parties' stacked shares (S = 3): a dense product
(M, K) x (K, N), or the grouped depthwise product, C channels of
(M, 9) x (9, 1).  The work of a launch is ``3 * dots * 2*M*K*N`` int8
operations (times C when grouped), with ``dots`` = 20 for a shared weight
(the fused RSS identity's two ring products, each ten 8-bit limb pairs)
and ``4, 7, 9, 10`` for a public weight of 1-4 balanced limbs.  Its bytes
are the least the layer must move: each input once and each output once,
the parties' int32 input words, the weight (two int32 share stacks, or the
public weight's int8 limbs) and the int32 output words.  A convolution's
input is its activation as it stands (B x H x W x C words a party), not
the k x k patches that the system expands it into before the launch, so a
kernel that gathers its patches itself is held to the same floor.  The
operations are the system's cost model's formulas as they stood when this
benchmark was written, copied here so that no later change to the system
moves the yardstick.
"""
from __future__ import annotations

from . import peaks

__all__ = ["SHARE_DOTS", "PUBLIC_DOTS", "launches", "query_ops", "bound_s"]

SHARE_DOTS = 20
PUBLIC_DOTS = (4, 7, 9, 10)     # 1-4 public limbs: sum over q < L of 4 - q
S = 3                           # the parties' stacked share slots


def _launch(family: str, m: int, k: int, n: int, c: int,
            limbs: int | None, words_in: int) -> dict:
    """``words_in``: a party's input words (all C channels)."""
    dots = SHARE_DOTS if limbs is None else PUBLIC_DOTS[limbs - 1]
    ops = S * dots * 2 * m * k * n * c
    if limbs is None:
        nbytes = 4 * (S * words_in + 2 * S * c * k * n + S * c * m * n)
    else:
        nbytes = 4 * S * words_in + c * k * n * limbs + 4 * S * c * m * n
    return {"family": family, "M": m, "K": k, "N": n, "C": c,
            "limbs": limbs, "ops": ops, "bytes": nbytes}


def launches(layers: list, input_shape, batch: int,
             public_limbs: list | None = None) -> list[dict]:
    """The product launches of one query, in order.  ``public_limbs``
    (public weights) gives each linear layer's limb counts, one a weight
    part, in layer order; ``None`` means shared weights."""
    h, w, c = (int(d) for d in input_shape)
    out, li = [], 0
    for l in layers:
        kind = l["kind"]
        if kind in ("conv", "sepconv", "fc"):
            lim = (None, None) if public_limbs is None else public_limbs[li]
            li += 1
            if kind == "fc":
                out.append(_launch("dense", batch, c, l["out"], 1, lim[0],
                                   batch * c))
                c = l["out"]
                continue
            k, st, pad = l["k"], l.get("stride", 1), l.get("pad", 0)
            words_in = batch * h * w * c
            h, w = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
            m = batch * h * w
            if kind == "sepconv":
                out.append(_launch("depthwise", m, k * k, 1, c, lim[0],
                                   words_in))
                out.append(_launch("dense", m, c, l["out"], 1, lim[1],
                                   m * c))
            else:
                out.append(_launch("dense", m, k * k * c, l["out"], 1,
                                   lim[0], words_in))
            c = l["out"]
        elif kind == "maxpool":
            h, w = h // 2, w // 2
        elif kind == "flatten":
            c, h, w = h * w * c, 1, 1
    return out


def query_ops(launch_list: list[dict]) -> int:
    return sum(x["ops"] for x in launch_list)


def bound_s(launch: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the int8 peak."""
    return max(launch["bytes"] / peaks.HBM_BPS,
               launch["ops"] / peaks.INT8_OPS)
