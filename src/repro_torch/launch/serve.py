"""Serving launcher: batched autoregressive decode with a KV / state cache.

Port of ``repro/launch/serve.py`` (``make_prefill_ingest``, ``main``).
Prompt ingest runs the decode step over every prompt position, filling the
cache (the reference compiles that loop into one ``lax.scan``; here it is
a Python loop of eager steps); decode then takes one step per generated
token, greedily (text tokens only, as the reference: pixtral decodes no
patches; MLA decodes absorbed; an encoder-only model raises
``ValueError``).  Parameters are random (``nn.transformer.init_params``
from seed 0, as the reference's ``PRNGKey(0)``) at the config's published
widths, or the reduced config with ``--reduced``.  Runs on the card unless
``--device cpu`` is given; ``--profile`` breaks one more decode step down
by device kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --batch 4 --prompt-len 16 --gen 32 [--device cpu] \
      [--profile]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ArchConfig, get_config
from ..device import resolve_device
from ..nn import transformer as tfm
from . import steps as steps_lib
from .profiling import print_profile, profile_once, sync

__all__ = ["make_prefill_ingest", "serve", "main"]


def make_prefill_ingest(cfg):
    """``prefill(params, cache, tokens (B, L)) -> (last logits (B, V),
    cache)``: the decode step over every prompt position."""
    step = steps_lib.make_decode_step(cfg)

    def prefill(params, cache, tokens):
        logits = None
        for pos in range(tokens.shape[1]):
            logits, cache = step(params, cache,
                                 {"tokens": tokens[:, pos:pos + 1],
                                  "pos": pos})
        return logits[:, 0], cache

    return prefill


def serve(arch: str | ArchConfig, reduced: bool = False, batch: int = 4,
          prompt_len: int = 16, gen: int = 32, max_seq: int = 128,
          device=None, params=None, profile: bool = False) -> dict:
    """Ingest a random (batch, prompt_len) prompt, then decode ``gen``
    tokens (the first from the prompt's last logits); the prompt, and the
    weights unless ``params`` are given, come from seed 0.  ``arch`` is a
    registered name or an ``ArchConfig`` (e.g. a published config cut to
    fewer layers).  Returns the stats dict: prefill and decode seconds
    and tok/s, the sampled tokens (batch, gen), whether the logits of
    every sampled token were finite, peak device memory on a card; with
    ``profile``, the device-time breakdown of the last decode step run
    once more."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    if batch < 1 or prompt_len < 1 or gen < 1:
        raise ValueError("batch, prompt_len and gen must be >= 1")
    if prompt_len + gen - 1 > max_seq:
        raise ValueError(f"prompt_len + gen - 1 = {prompt_len + gen - 1} "
                         f"positions do not fit max_seq {max_seq}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if params is None:
        params = tfm.init_params(cfg, 0, device)
    cache = tfm.init_cache(cfg, batch, max_seq, device)
    prefill = make_prefill_ingest(cfg)
    step = steps_lib.make_decode_step(cfg)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(0)) \
        .to(device)

    sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompt)
    sync(device)
    t_prefill = time.perf_counter() - t0

    toks = logits.argmax(-1).to(torch.int64)[:, None]
    out_tokens = [toks]
    finite = torch.isfinite(logits).all()     # stays on the device
    n_steps = gen - 1      # the first generated token came out of prefill
    last = {"tokens": prompt[:, -1:], "pos": prompt_len - 1}
    t1 = time.perf_counter()
    for pos in range(prompt_len, prompt_len + n_steps):
        last = {"tokens": toks, "pos": pos}
        logits, cache = step(params, cache, last)
        toks = logits.argmax(-1)
        finite &= torch.isfinite(logits).all()
        out_tokens.append(toks)
    sync(device)
    t_decode = time.perf_counter() - t1
    # the last step once more: it rewrites the same KV slot (an SSM state
    # advances one more token; nothing reads it afterwards)
    prof = profile_once(lambda: step(params, cache, last), device,
                        t_decode / n_steps if n_steps
                        else t_prefill / prompt_len) if profile else None

    p_toks, d_toks = batch * prompt_len, batch * n_steps
    return {"arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
            "gen": gen, "device": str(device),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "prefill_s": t_prefill, "prefill_tok_s": p_toks / t_prefill,
            "decode_steps": n_steps, "decode_s": t_decode,
            "decode_tok_s": d_toks / t_decode if n_steps else None,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
            "profile": prof, "logits_finite": bool(finite),
            "tokens": torch.cat(out_tokens, dim=1).cpu().numpy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more decode step: device time by "
                         "kernel")
    args = ap.parse_args(argv)
    st = serve(args.arch, args.reduced, args.batch, args.prompt_len,
               args.gen, args.max_seq, args.device, profile=args.profile)
    decode_msg = (f"decode {st['decode_steps']} steps in "
                  f"{st['decode_s']:.2f}s ({st['decode_tok_s']:.1f} tok/s); "
                  if st["decode_steps"] else "")
    mem = (f"; peak memory {st['peak_mem_bytes'] / 2**30:.2f} GiB"
           if st["peak_mem_bytes"] is not None else "")
    print(f"[serve] {st['arch']} on {st['device']} ({st['kind']}): prefill "
          f"{st['batch']}x{st['prompt_len']} in {st['prefill_s']:.2f}s "
          f"({st['prefill_tok_s']:.1f} tok/s, decode-step ingest); "
          f"{decode_msg}sample: {st['tokens'][0, :10].tolist()}{mem}")
    if st["profile"] is not None:
        print_profile("serve", "decode step", st["profile"])
    return st


if __name__ == "__main__":
    main()
