"""Roofline terms of the LM paths on one NVIDIA H100: the analytic half.

Port of ``repro/roofline/analyze.py`` (``summarize_memory``,
``analytic_flops``, ``analytic_bytes``, ``model_flops``,
``span_totals_from_trace``, ``roofline_terms``).  The peaks are the
card's, from ``repro_torch.peaks`` (re-exported here): bf16 989 TFLOP/s
for the compute term, HBM 3.35 TB/s for the memory term.

One card has no inter-chip link, and the gloo ranks of a mesh run have no
link worth a peak: ``roofline_terms`` takes the link rate from its caller
(``link_bps``) and counts no collective time without one.

Two counts differ from the reference on purpose:

* ``active_param_count`` is the port's (``configs``): for jamba the
  reference counts every layer as MoE (51,459,264,000 against the port's
  11,999,251,968);
* the port's train step keeps every activation (no remat), so a train
  step counts forward + 2 x backward = 3 x the forward, where the
  reference's ``remat`` default counts 4 x.

A shape is a ``configs.SHAPES`` name or a dict with its ``kind``
("train", "prefill" or "decode"), ``global_batch`` and ``seq_len``.

The reference's HLO half parses XLA's compiled text and has no
counterpart here; the port measures the same things directly:

* ``collective_bytes_from_hlo``: the dry run's collective count
  (``launch.dryrun.CollectiveCounter``), which returns the same keys,
  ``{op: {"count", "bytes"}, "total_bytes"}``;
* ``party_wire_bytes_from_hlo`` and ``ledger_vs_wire``: each mesh rank's
  ``core.transport.WireCounter``, held against the ``CommLedger``;
* ``prf_ops_in_hlo``: a count of ``core.prf._threefry_tensor`` calls
  around an online query (zero when the tape pool serves it).
"""
from __future__ import annotations

from ..configs import SHAPES
from ..peaks import BF16_OPS, FP32_OPS, HBM_BPS, INT8_OPS

__all__ = ["BF16_OPS", "INT8_OPS", "FP32_OPS", "HBM_BPS", "PEAK_FLOPS",
           "HBM_BW", "shape_info", "summarize_memory", "analytic_flops",
           "analytic_bytes", "model_flops", "span_totals_from_trace",
           "roofline_terms"]

# the reference's names for the two peaks the roofline terms read
PEAK_FLOPS = BF16_OPS
HBM_BW = HBM_BPS


def shape_info(shape) -> tuple[int, int, str]:
    """(global_batch, seq_len, kind) of a ``SHAPES`` name or a dict."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    if info["kind"] not in ("train", "prefill", "decode"):
        raise ValueError(f"shape kind {info['kind']!r}: train, prefill or "
                         f"decode")
    return int(info["global_batch"]), int(info["seq_len"]), info["kind"]


def summarize_memory(mem) -> dict:
    """The reference's memory record from an object (or dict) with
    ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``, ``alias_size_in_bytes`` and
    ``generated_code_size_in_bytes`` (-1 for one it lacks)."""
    def get(attr):
        v = mem.get(attr, -1) if isinstance(mem, dict) \
            else getattr(mem, attr, -1)
        return int(v)
    return {
        "argument_bytes": get("argument_size_in_bytes"),
        "output_bytes": get("output_size_in_bytes"),
        "temp_bytes": get("temp_size_in_bytes"),
        "alias_bytes": get("alias_size_in_bytes"),
        "generated_code_bytes": get("generated_code_size_in_bytes"),
        "peak_bytes_est": (get("argument_size_in_bytes")
                           + get("output_size_in_bytes")
                           + get("temp_size_in_bytes")
                           - max(get("alias_size_in_bytes"), 0)),
    }


def _attn_layers(cfg) -> int:
    if cfg.attn_period:
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers if cfg.n_heads else 0


def _mamba_layers(cfg) -> int:
    if cfg.ssm and cfg.attn_period:
        return cfg.n_layers - cfg.n_layers // cfg.attn_period
    return cfg.n_layers if cfg.ssm else 0


def analytic_flops(cfg, shape) -> float:
    """Analytic FLOPs of one step (global): the matmul parameters and the
    attention / SSD terms; a train step is 3 x its forward (no remat)."""
    b, s, kind = shape_info(shape)
    n_matmul = cfg.active_param_count() - cfg.vocab * cfg.d_model  # lookup
    hd_qk = cfg.head_dim + (cfg.rope_head_dim if cfg.mla else 0)
    if kind in ("train", "prefill"):
        fwd = 2.0 * n_matmul * b * s
        # causal attention: QK^T + AV, half the square
        fwd += _attn_layers(cfg) * (2.0 * b * s * s * cfg.n_heads
                                    * (hd_qk + cfg.head_dim) / 2.0
                                    * (1.0 if not cfg.encoder_only else 2.0))
        if cfg.ssm:
            from ..nn.ssm import CHUNK
            q = cfg.ssd_chunk or CHUNK
            h = cfg.mamba_expand * cfg.d_model // cfg.mamba_head_dim
            n = cfg.ssm_state
            per_tok = 2.0 * (q * n + q * h * cfg.mamba_head_dim
                             + 2 * h * cfg.mamba_head_dim * n)
            fwd += _mamba_layers(cfg) * b * s * per_tok
        return fwd * 3.0 if kind == "train" else fwd
    # decode: one token, full-cache attention reads
    fwd = 2.0 * n_matmul * b
    if cfg.mla:
        # absorbed path: scores and combine in latent space r, per head
        fwd += _attn_layers(cfg) * 2.0 * b * s * cfg.n_heads \
            * (cfg.kv_lora_rank + cfg.rope_head_dim + cfg.kv_lora_rank)
    else:
        fwd += _attn_layers(cfg) * 2.0 * b * s * cfg.n_heads \
            * (hd_qk + cfg.head_dim)
    if cfg.ssm:
        h = cfg.mamba_expand * cfg.d_model // cfg.mamba_head_dim
        fwd += _mamba_layers(cfg) * 4.0 * b * h * cfg.mamba_head_dim \
            * cfg.ssm_state
    return fwd


def analytic_bytes(cfg, shape, n_chips: int = 1) -> float:
    """Analytic HBM traffic of one step (global bytes), fusion-optimistic.
    ``n_chips`` is the reference's argument; the count is global."""
    b, s, kind = shape_info(shape)
    n = cfg.param_count()
    if kind == "train":
        # fwd param read + bwd param read + grad write + adam m/v rw + p rw
        param_traffic = n * 4.0 * (1 + 1 + 1 + 4 + 2)
        tokens = b * s
        act = tokens * cfg.d_model * 2.0 * cfg.n_layers * 3  # boundaries rw
        logits = tokens * cfg.vocab * 2.0 * 3
        return param_traffic + act + logits
    if kind == "prefill":
        return n * 4.0 + b * s * cfg.d_model * 2.0 * cfg.n_layers * 2
    # decode: active params + full cache read
    cache = 0.0
    if cfg.mla:
        cache = (cfg.n_layers * b * s
                 * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2.0)
    elif cfg.n_heads and not cfg.ssm:
        cache = cfg.n_layers * b * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
    elif cfg.attn_period:
        cache = (cfg.n_layers // cfg.attn_period) * b * s \
            * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
    if cfg.ssm:
        h = cfg.mamba_expand * cfg.d_model // cfg.mamba_head_dim
        cache += _mamba_layers(cfg) * b * h * cfg.mamba_head_dim \
            * cfg.ssm_state * 4.0 * 2
    return cfg.active_param_count() * 4.0 + cache


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for a train step, 2·N_active·D for
    inference (global; a decode step is one token a request)."""
    b, s, kind = shape_info(shape)
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * b * s
    if kind == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b


def span_totals_from_trace(trace: dict) -> dict:
    """Per-category and per-span duration totals of a Chrome trace-event
    export (``core.telemetry.Tracer.chrome_trace``).  Only complete
    ``"ph": "X"`` events carry durations; a ``lane="parties"`` span fans
    out to one event per party (same name, cat, ts and dur) and counts
    once.  Returns ``{"by_cat": {cat: {"us", "count"}}, "by_span":
    {(cat, name): {"us", "count"}}, "total_us"}``."""
    by_cat: dict[str, dict] = {}
    by_span: dict[tuple, dict] = {}
    seen: set = set()
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        key = (ev.get("cat", ""), ev["name"], ev["ts"], ev["dur"])
        if key in seen:   # party-lane fanout copy
            continue
        seen.add(key)
        cat, dur = ev.get("cat", ""), float(ev["dur"])
        c = by_cat.setdefault(cat, {"us": 0.0, "count": 0})
        c["us"] += dur
        c["count"] += 1
        sp = by_span.setdefault((cat, ev["name"]), {"us": 0.0, "count": 0})
        sp["us"] += dur
        sp["count"] += 1
    return {"by_cat": by_cat, "by_span": by_span,
            "total_us": sum(v["us"] for v in by_cat.values())}


def roofline_terms(cfg, shape, cost: dict | None, colls: dict,
                   n_chips: int = 1, link_bps: float | None = None) -> dict:
    """The step's bound on ``n_chips`` H100s: compute, memory and
    collective seconds per chip, which dominates, and the model-FLOPs
    shares.  ``cost``: a measured ``{"flops", "bytes accessed"}`` per chip
    (None: the analytic counts alone); ``colls``: the collective record
    (``{"total_bytes": ...}``, bytes per chip); ``link_bps``: the link's
    bytes/s (None: no collective term)."""
    hlo_flops = float(cost.get("flops", -1.0)) if cost else -1.0
    hlo_bytes = float(cost.get("bytes accessed", -1.0)) if cost else -1.0
    ana_flops = analytic_flops(cfg, shape) / n_chips
    ana_bytes = analytic_bytes(cfg, shape, n_chips) / n_chips
    # a measured count and the analytic one each undercount something:
    # take the larger as the per-chip estimate
    flops = max(hlo_flops, ana_flops)
    byts = max(min(hlo_bytes, 10 * ana_bytes) if hlo_bytes > 0 else ana_bytes,
               ana_bytes)
    cbytes = colls.get("total_bytes", 0)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / link_bps if link_bps else 0.0
    mf = model_flops(cfg, shape)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s, "link_bps": link_bps,
             "hlo_flops_per_chip": hlo_flops,
             "analytic_flops_per_chip": ana_flops,
             "hlo_bytes_per_chip": hlo_bytes,
             "analytic_bytes_per_chip": ana_bytes,
             "model_flops_global": mf,
             "model_flops_per_chip": mf / n_chips,
             "useful_flops_frac": (mf / n_chips) / flops if flops > 0
             else None}
    vals = {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s}
    dom = max(vals, key=vals.get)
    terms["dominant"] = dom.replace("_s", "")
    step_time = max(vals.values())
    terms["step_time_bound_s"] = step_time
    if step_time > 0:
        # fraction of roofline: useful model flops over the step bound
        terms["roofline_frac"] = (mf / n_chips / PEAK_FLOPS) / step_time
    return terms
