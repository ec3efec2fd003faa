"""Carrying weights and ring tensors across from the JAX package.

``params_from_numpy`` takes a parameter dict as numpy arrays (the JAX
package's ``init_bnn`` output or a trained checkpoint, ``np.asarray`` of
each leaf) into the port's float32 tensors.  Ring tensors cross as raw
bits: the reference's ``uint32`` words are the port's ``int32`` words.
``grid_quantize`` is the grid-quantised weight trick of the reference's
secure-vs-plaintext tests, under which the secure logits provably equal
the plaintext forward's to within the fixed-point noise.
``lm_params_from_numpy`` takes the JAX package's LM parameters (its
``nn.transformer.init_params`` output as numpy arrays) into the port's
``LM`` module, splitting each stacked layer group along its first axis
(deepseek's ``group0`` dense and ``group1`` MoE layers become consecutive
``layers``; the top-level ``front_proj``, ``mtp_norm`` and ``mtp_proj``
keep their names).
``params_to_numpy`` and ``lm_params_to_numpy`` go the other way (the LM's
layers restacked per group), for checkpoints either package restores;
``lm_tree`` / ``lm_flat`` convert any per-parameter mapping (AdamW's
moments too) between the two layouts.  ``lm_cache_from_numpy`` takes the
reference's decode cache (``init_cache``'s ``group{i}`` leaves stacked
over the group's layers, jamba's sub-layer dicts nested) into the port's
one dict a layer, each leaf in the port's dtype; ``lm_cache_to_numpy``
goes back (bf16 leaves as float32 arrays, which hold them exactly).
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.transformer import LM, layer_groups

__all__ = ["params_from_numpy", "params_to_numpy", "lm_params_from_numpy",
           "lm_params_to_numpy", "lm_tree", "lm_flat", "lm_cache_from_numpy",
           "lm_cache_to_numpy", "ring_from_numpy",
           "ring_to_numpy", "grid_quantize", "to_host"]


def params_from_numpy(params: dict, device="cpu") -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's BNN parameter dict -> float32 numpy arrays (the
    reference's layout: the same keys and shapes)."""
    return {k: to_host(v) for k, v in params.items()}


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def lm_flat(tree: dict, cfg) -> dict:
    """The reference's nested LM layout (``group{i}`` leaves stacked over
    the group's layers) -> a flat ``{module name: array}`` mapping in the
    port's names (``layers.{j}.attn.wq``, ``embed``, ...)."""
    flat, first = {}, 0
    for gi, g in enumerate(layer_groups(cfg)):
        for name, arr in _leaves(tree[f"group{gi}"]):
            assert arr.shape[0] == g.count, (name, arr.shape, g.count)
            for i in range(g.count):
                flat[f"layers.{first + i}.{name}"] = arr[i]
        first += g.count
    flat.update(_leaves({k: v for k, v in tree.items()
                         if not k.startswith("group")}))
    return flat


def lm_tree(flat: dict, cfg) -> dict:
    """Inverse of :func:`lm_flat`: each group's layers restacked on a
    leading axis, other names nested by their dots."""
    tree, first = {}, 0
    for gi, g in enumerate(layer_groups(cfg)):
        names = sorted({k.split(".", 2)[2] for k in flat
                        if k.startswith("layers.")
                        and first <= int(k.split(".")[1]) < first + g.count})
        for name in names:
            _nest(tree, f"group{gi}.{name}", np.stack(
                [to_host(flat[f"layers.{first + i}.{name}"])
                 for i in range(g.count)]))
        first += g.count
    for k, v in flat.items():
        if not k.startswith("layers."):
            _nest(tree, k, to_host(v))
    return tree


def to_host(a) -> np.ndarray:
    """A tensor (any device) or array-like -> a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _nest(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def lm_params_from_numpy(params: dict, cfg, device="cpu") -> LM:
    """The reference's nested LM parameter dict (``group{i}`` leaves stacked
    over the group's layers) -> the port's ``LM`` on ``device``."""
    model = LM(cfg, device="meta")
    model.load_state_dict({k: torch.tensor(v, device=device)
                           for k, v in lm_flat(params, cfg).items()},
                          strict=True, assign=True)
    return model


def lm_params_to_numpy(model: LM, cfg) -> dict:
    """The port's ``LM`` -> the reference's nested float32 numpy layout."""
    return lm_tree(model.state_dict(), cfg)


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def lm_cache_from_numpy(cache: dict, cfg, device="cpu") -> list[dict]:
    """The reference's decode cache (``group{i}`` leaves stacked over the
    group's layers, as numpy arrays or array-likes) -> the port's list of
    one cache dict a layer; the Mamba-2 state in float32, every other
    leaf in the compute dtype."""
    from .nn.layers import COMPUTE_DTYPE

    def leaf(i):
        return lambda k, a: torch.tensor(
            np.asarray(a, np.float32)[i], device=device).to(
                torch.float32 if k == "state" else COMPUTE_DTYPE)
    return [_map(cache[f"group{gi}"], leaf(i))
            for gi, g in enumerate(layer_groups(cfg)) for i in range(g.count)]


def lm_cache_to_numpy(cache: list, cfg) -> dict:
    """Inverse of :func:`lm_cache_from_numpy`: each group's layers
    restacked on a leading axis, every leaf a float32 array."""
    out, first = {}, 0
    for gi, g in enumerate(layer_groups(cfg)):
        layers = cache[first:first + g.count]

        def stack(tree, path):
            return {k: stack(v, path + [k]) if isinstance(v, dict)
                    else np.stack([_at(c, path + [k]) for c in layers])
                    for k, v in tree.items()}
        out[f"group{gi}"] = stack(layers[0], [])
        first += g.count
    return out


def _at(tree: dict, path: list) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return to_host(tree.float())


def ring_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 ring words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def ring_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 ring tensor -> uint32 numpy words with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def grid_quantize(params: dict) -> dict:
    """Weights on a 1/8 grid (halved), biases on 1/8 plus a 1/256 half
    step, identity BN: every pre-activation stays ≥ 1/256 away from the
    Sign boundary for ±0.5 inputs, far outside the truncation noise."""
    out = {}
    for name, p in params.items():
        if name.endswith("_var"):
            out[name] = torch.full_like(p, 1.0 - 1e-5)
        elif name.endswith(("_mu", "_beta")):
            out[name] = torch.zeros_like(p)
        elif name.endswith("_g"):
            out[name] = torch.ones_like(p)
        elif p.ndim > 1:
            out[name] = torch.round(p * 0.5 * 8) / 8
        else:
            out[name] = torch.round(p * 8) / 8 + 1.0 / 256
    return out
