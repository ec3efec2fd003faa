"""The port's roofline terms (``repro_torch.roofline.analyze``) against the
reference's ``repro.roofline.analyze``.

Every count is held exactly (float equality: the same float64 arithmetic
in the same order) for all ten architectures and all four ``SHAPES``
cells, apart from the two differences the port makes on purpose: the
reference's config is taken with ``remat=False`` (the port's train step
keeps every activation: 3 x the forward, not 4 x), and for jamba the
reference reads the port's ``active_param_count`` (the reference counts
every jamba layer as MoE).  ``roofline_terms`` is held to the
reference's with the reference's peaks patched to the H100's.
"""
import dataclasses

import pytest

import repro.roofline.analyze as jroof
from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro_torch import configs
from repro_torch.core import telemetry
from repro_torch.roofline import analyze as roof

LINK = 25e9   # a link rate passed in (bytes/s); the port has no default


class _PortActive:
    """The reference's config with the port's ``active_param_count``."""

    def __init__(self, ref, port):
        self._ref, self._port = ref, port

    def __getattr__(self, name):
        return getattr(self._ref, name)

    def active_param_count(self):
        return self._port.active_param_count()


def _ref_cfg(arch):
    ref = dataclasses.replace(ref_config(arch), remat=False)
    port = configs.get_config(arch)
    if ref.active_param_count() != port.active_param_count():
        assert arch == "jamba-v0.1-52b", arch
        return _PortActive(ref, port)
    return ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_reference(arch):
    cfg, ref = configs.get_config(arch), _ref_cfg(arch)
    for shape in SHAPES:
        assert roof.analytic_flops(cfg, shape) \
            == jroof.analytic_flops(ref, shape), (arch, shape)
        assert roof.analytic_bytes(cfg, shape, 256) \
            == jroof.analytic_bytes(ref, shape, 256), (arch, shape)
        assert roof.model_flops(cfg, shape) \
            == jroof.model_flops(ref, shape), (arch, shape)
        # a shape given by its fields counts as its SHAPES name
        info = dict(SHAPES[shape])
        assert roof.analytic_flops(cfg, info) \
            == roof.analytic_flops(cfg, shape)


def test_train_step_counts_three_forwards():
    cfg = configs.get_config("tinyllama-1.1b")
    train = {"kind": "train", "global_batch": 4, "seq_len": 256}
    fwd = dict(train, kind="prefill")
    assert roof.analytic_flops(cfg, train) \
        == 3.0 * roof.analytic_flops(cfg, fwd)
    assert roof.model_flops(cfg, train) == 3.0 * roof.model_flops(cfg, fwd)
    with pytest.raises(ValueError):
        roof.model_flops(cfg, dict(train, kind="serve"))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "mamba2-1.3b"])
@pytest.mark.parametrize("cost", [None, {"flops": 3e15,
                                         "bytes accessed": 4e12}])
def test_roofline_terms_equal_reference_at_h100_peaks(arch, cost,
                                                      monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roof.BF16_OPS)
    monkeypatch.setattr(jroof, "HBM_BW", roof.HBM_BPS)
    monkeypatch.setattr(jroof, "ICI_BW", LINK)
    cfg, ref = configs.get_config(arch), _ref_cfg(arch)
    colls = {"all-gather": {"count": 3, "bytes": 7e9}, "total_bytes": 7e9}
    for shape in SHAPES:
        got = roof.roofline_terms(cfg, shape, cost, colls, 256, LINK)
        want = jroof.roofline_terms(ref, shape, cost, colls, 256)
        assert got.pop("link_bps") == LINK
        assert got == {k: v for k, v in want.items()
                       if k != "collective_s_4link"}, (arch, shape)
    # without a link rate the collective term is 0 and the rest stands
    got = roof.roofline_terms(cfg, "train_4k", cost, colls, 256)
    assert got["collective_s"] == 0.0 and got["dominant"] != "collective"


def test_summarize_memory_equals_reference():
    class Mem:
        argument_size_in_bytes = 1000
        output_size_in_bytes = 200
        temp_size_in_bytes = 300
        alias_size_in_bytes = 100
    assert roof.summarize_memory(Mem()) == jroof.summarize_memory(Mem())
    assert roof.summarize_memory({"argument_size_in_bytes": 5}) \
        == jroof.summarize_memory(type("M", (), {
            "argument_size_in_bytes": 5})())


def test_span_totals_equal_reference_on_a_telemetry_trace():
    clock = iter(float(t) for t in range(1000)).__next__
    tr = telemetry.Tracer(parties=3, clock=clock)
    with tr.span("compile", cat="compile"):
        pass
    for q in range(3):
        with tr.span(f"query[{q}]", cat="online"):
            with tr.span("l0.fc", cat="online", lane="parties"):
                pass
    tr.instant("marker")
    trace = tr.chrome_trace()
    got = roof.span_totals_from_trace(trace)
    assert got == jroof.span_totals_from_trace(trace)
    # the party lane fans out to three events and counts once
    assert got["by_span"][("online", "l0.fc")]["count"] == 3
    assert got["total_us"] > 0
